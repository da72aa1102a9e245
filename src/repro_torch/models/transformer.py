"""Model assembly: embeddings, the block stack, caches, and the forward /
prefill / decode entry points.

Layouts (over token inputs):
  attn_mlp — a standard decoder (``smat-ffn`` with its block-sparse FFN,
             ``smat-attn`` with block-sparse attention scores on top);
  mla_moe  — DeepSeek MLA attention + a shared/routed MoE FFN;
  ssd      — Mamba2 (attention-free).
The JAX package's ``gemma_pair`` and ``zamba`` layouts and its
``tokens+patches`` and ``codebooks`` inputs are not ported yet (ROADMAP A7).

The JAX package stacks the blocks on a leading axis and scans them; here
``Transformer.blocks`` is a ``ModuleList`` walked by a Python loop, and the
decode cache keeps the stacked layout (``{"k", "v"}: [n_layers, B, S, KV,
dh]``; ``{"ckv", "krope"}: [n_layers, B, S, r | rope]``; ``{"conv",
"state"}: [n_layers, B, cw-1, d_xbc | H, P, N]``) so a layer's cache is a
view into it.  ``forward``'s third value sums the layers' MoE
load-balance losses, as the JAX package's scan carries it.  ``forward``'s ``remat``
replaces the JAX package's ``jax.checkpoint`` policies: ``"full"`` runs
each block under ``torch.utils.checkpoint``; ``"dots"`` and ``"names"`` are
not ported yet.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import meta_spec as _spec
from repro_torch.core.sparse_linear import sparse_linear_specs
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

LAYOUTS = ("attn_mlp", "mla_moe", "ssd")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (``"cuda"`` names the current card,
    ``cuda:<index>``, so it compares equal to a tensor's device); raises for
    a CUDA device on a machine without one, so an entry point never quietly
    runs on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly to "
                "run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_layout(cfg: ModelConfig) -> None:
    if cfg.layout not in LAYOUTS or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"layout {cfg.layout!r} with input_mode {cfg.input_mode!r} is not "
            f"ported yet (ROADMAP A7; ported: {', '.join(LAYOUTS)} over "
            "tokens)")


class Block(nn.Module):
    """One layer, its parameters named as the JAX package's ``blocks``
    tree: ``attn_mlp`` (pre-norm attention ``ln1``/``attn``, then pre-norm
    MLP ``ln2``/``mlp``), ``mla_moe`` (``ln1``/``mla``, then ``ln2``/
    ``moe``) or ``ssd`` (``ln``/``ssd``)."""

    def __init__(self, cfg, *, dtype, device, generator=None,
                 seed_hint: int = 0):
        super().__init__()
        d = cfg.d_model
        if cfg.layout == "ssd":
            self.ln = nn.Parameter(torch.zeros(d, device=device))
            self.ssd = S.init_ssd(cfg, generator, dtype, device=device)
            return
        self.ln1 = nn.Parameter(torch.zeros(d, device=device))
        if cfg.layout == "mla_moe":
            self.mla = L.init_mla(cfg, generator, dtype, device=device)
        else:
            self.attn = L.init_attention(cfg, generator, dtype,
                                         device=device)
        self.ln2 = nn.Parameter(torch.zeros(d, device=device))
        if cfg.layout == "mla_moe":
            self.moe = M.init_moe(cfg, generator, dtype, device=device)
        else:
            self.mlp = L.init_mlp(cfg, generator, dtype, device=device,
                                  seed_hint=seed_hint)


class Transformer(nn.Module):
    """The decoder.  Dense weights are drawn from ``generator`` (left
    uninitialised when it is None); the sparse FFN structures and values
    always come from their numpy seeds, as in the JAX package."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        _check_layout(cfg)
        self.cfg = cfg
        dtype, d = _dtype(cfg), cfg.d_model
        self.final_norm = nn.Parameter(torch.zeros(d, device=device))
        self.embed = L._weight((cfg.vocab_size, d), 0.02, dtype, device,
                               generator)
        self.lm_head = L._weight((d, cfg.vocab_size), d ** -0.5, dtype,
                                 device, generator)
        self.blocks = nn.ModuleList(
            Block(cfg, dtype=dtype, device=device, generator=generator,
                  seed_hint=i) for i in range(cfg.n_layers))

    def forward(self, batch_in, *, cache=None, pos=None, slot_mask=None,
                remat: str = "none"):
        return forward(self.cfg, self, batch_in, cache=cache, pos=pos,
                       slot_mask=slot_mask, remat=remat)


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> Transformer:
    """The model with random weights from ``seed`` on ``device``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return Transformer(cfg, device=device, generator=generator)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device="cuda"):
    """Decode caches for the whole network, stacked over layers."""
    _check_layout(cfg)
    device, dtype = resolve_device(device), _dtype(cfg)
    if cfg.layout == "mla_moe":
        one = L.init_mla_cache(cfg, batch, cache_len, dtype, device=device)
    elif cfg.layout == "ssd":
        one = S.init_ssd_cache(cfg, batch, dtype, device=device)
    else:
        one = L.init_attn_cache(cfg, batch, cache_len, dtype,
                                window=cfg.sliding_window, device=device)
    return {name: leaf[None].repeat(cfg.n_layers, *([1] * leaf.ndim))
            for name, leaf in one.items()}


# ============================================================ specs (no data)
def _block_specs(cfg: ModelConfig, i: int, device) -> dict:
    """Specs of layer ``i``: the JAX tree's ``blocks`` leaves at index
    ``i`` (``convert.params_from_jax``'s unstacking), plus each sparse
    layer's port buffers."""
    dtype, d = _dtype(cfg), cfg.d_model
    if cfg.layout in ("mla_moe", "ssd"):        # no sparse layer in these
        return _module_specs(Block(cfg, dtype=dtype, device="meta"))
    h, kv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    attn = {"wq": _spec((d, h * hd), dtype), "wk": _spec((d, kv * hd), dtype),
            "wv": _spec((d, kv * hd), dtype), "wo": _spec((h * hd, d), dtype)}
    if cfg.qkv_bias:
        attn.update(bq=_spec((h * hd,), dtype), bk=_spec((kv * hd,), dtype),
                    bv=_spec((kv * hd,), dtype))
    spec = cfg.ffn_sparsity
    if spec is not None:
        seed = L.mlp_seed(i)
        mlp = {name: sparse_linear_specs(i_, o_, spec, dtype, seed=s_,
                                         device=device)[0]
               for name, s_, i_, o_ in (("gate", seed, d, f),
                                        ("up", seed + 1, d, f),
                                        ("down", seed + 2, f, d))}
    else:
        mlp = {"w_gate": _spec((d, f), dtype), "w_up": _spec((d, f), dtype),
               "w_down": _spec((f, d), dtype)}
    f32 = torch.float32
    return {"ln1": _spec((d,), f32), "attn": attn, "ln2": _spec((d,), f32),
            "mlp": mlp}


def _module_specs(module: nn.Module) -> dict:
    """A module's parameters as a nested ``{name: meta tensor}`` tree, for
    a module built on the ``meta`` device (shapes and dtypes only)."""
    out: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach()
    return out


def param_specs(cfg: ModelConfig, *, device="cuda") -> dict:
    """The model's parameters and buffers as tensors on the ``meta``
    device (shape and dtype, no storage, no random draw): the JAX
    package's ``param_specs`` tree with ``blocks`` unstacked into a list of
    layers, as ``convert.params_from_jax`` reads it, so ``flat_specs`` of
    it has ``Transformer.state_dict()``'s keys.  Sparse layers take their
    true structure metas (their numpy pattern seeds), which size the
    port's schedule buffers.  ``device`` only keys ``shards="auto"``."""
    _check_layout(cfg)
    dtype, d, V = _dtype(cfg), cfg.d_model, cfg.vocab_size
    return {"final_norm": _spec((d,), torch.float32),
            "embed": _spec((V, d), dtype), "lm_head": _spec((d, V), dtype),
            "blocks": [_block_specs(cfg, i, device)
                       for i in range(cfg.n_layers)]}


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """``init_cache``'s tensors as ``meta``-device specs (stacked over
    layers, the JAX package's layout)."""
    return init_cache(cfg, batch, cache_len, device="meta")


def flat_specs(tree, prefix: str = "") -> dict:
    """``{dotted path: leaf}`` of a nested spec tree (lists by index): the
    keys of ``Transformer.state_dict()`` for ``param_specs``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat_specs(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


# ================================================================== forward
def _embed(cfg: ModelConfig, params, batch_in) -> torch.Tensor:
    return params.embed[batch_in["tokens"]]                 # [B, L, D]


def _head(cfg: ModelConfig, params, x) -> torch.Tensor:
    x = L.rms_norm(x, params.final_norm)
    logits = x @ params.lm_head
    return L.softcap(logits.float(), cfg.final_logit_softcap)


def _apply_block(cfg: ModelConfig, p: Block, x, cache, pos, slot_mask=None):
    """Returns (x, cache, aux): ``aux`` is the layer's MoE load-balance
    loss (0 for the other layouts)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.layout == "ssd":
        y, c = S.ssd_block(cfg, p.ssd, L.rms_norm(x, p.ln), cache=cache,
                           pos=pos, slot_mask=slot_mask)
        return x + y, c, aux
    if cfg.layout == "mla_moe":
        a, c = L.mla_attention(cfg, p.mla, L.rms_norm(x, p.ln1), cache=cache,
                               pos=pos, slot_mask=slot_mask)
        x = x + a
        y, aux = M.moe_ffn(cfg, p.moe, L.rms_norm(x, p.ln2),
                           dispatch=cfg.moe_dispatch)
        return x + y, c, aux
    a, c = L.attention(cfg, p.attn, L.rms_norm(x, p.ln1),
                       window=cfg.sliding_window, cache=cache, pos=pos,
                       slot_mask=slot_mask)
    x = x + a
    x = x + L.mlp(cfg, p.mlp, L.rms_norm(x, p.ln2),
                  seed_hints=(p.mlp.seed_hint,))
    return x, c, aux


REMAT = ("none", "full")


def _remat_block(cfg: ModelConfig, blk: Block, x):
    """One block without a cache under activation checkpointing: its
    activations are recomputed in the backward (JAX ``remat="full"``).
    Returns (x, aux)."""
    def run(x_):
        x_, _, aux = _apply_block(cfg, blk, x_, None, None)
        return x_, aux
    return torch_checkpoint.checkpoint(run, x, use_reentrant=False)


def forward(cfg: ModelConfig, params: Transformer, batch_in, *, cache=None,
            pos=None, slot_mask=None, remat: str = "none"
            ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (logits, cache, aux_loss); the cache is updated in place.
    ``aux_loss`` sums the layers' MoE load-balance losses.
    ``remat="full"`` checkpoints each block (training, no cache)."""
    if remat in ("dots", "names"):
        raise NotImplementedError(
            f"remat={remat!r} (a jax.checkpoint policy) is not ported yet; "
            f"use one of {REMAT}")
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r}; want one of {REMAT}")
    x = _embed(cfg, params, batch_in)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(params.blocks):
        if remat == "full" and cache is None:
            x, a = _remat_block(cfg, blk, x)
        else:
            layer_cache = None if cache is None else \
                {name: leaf[i] for name, leaf in cache.items()}
            x, _, a = _apply_block(cfg, blk, x, layer_cache, pos, slot_mask)
        aux = aux + a
    return _head(cfg, params, x), cache, aux


# ================================================================ entry points
def lm_loss(cfg: ModelConfig, logits, labels) -> torch.Tensor:
    """Next-token CE.  labels already shifted; -100 = ignore."""
    valid = labels >= 0
    lab = labels.clamp_min(0).long()
    lp = torch.log_softmax(logits, dim=-1)
    nll = -lp.gather(-1, lab[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


def train_loss(cfg: ModelConfig, params: Transformer, batch_in,
               remat: str = "full"):
    """Returns (loss, {"lm_loss", "aux_loss"}); ``batch_in`` holds
    ``tokens`` and shifted ``labels`` (-100 = ignore)."""
    logits, _, aux = forward(cfg, params, batch_in, remat=remat)
    loss = lm_loss(cfg, logits, batch_in["labels"])
    return loss + 0.01 * aux, {"lm_loss": loss, "aux_loss": aux}


def prefill(cfg: ModelConfig, params: Transformer, batch_in, cache_len: int):
    """Build decode caches from a prompt.  Returns (logits, cache)."""
    B = batch_in["tokens"].shape[0]
    cache = init_cache(cfg, B, cache_len, device=params.embed.device)
    logits, cache, _ = forward(cfg, params, batch_in, cache=cache, pos=0)
    return logits, cache


def decode_step(cfg: ModelConfig, params: Transformer, cache, tokens,
                pos: int, slot_mask=None):
    """One decode step: tokens [B], pos an int.  Writes the step's K/V (MLA:
    latent; SSD: conv window and state) into ``cache`` in place (only the
    rows where ``slot_mask`` [B] is True, when given).  Returns (logits
    [B, V], cache)."""
    logits, cache, _ = forward(cfg, params, {"tokens": tokens[:, None]},
                               cache=cache, pos=pos, slot_mask=slot_mask)
    return logits[:, 0], cache
