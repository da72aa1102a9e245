"""Model assembly: embeddings, the block stack, caches, and the forward /
prefill / decode entry points for the ``attn_mlp`` layout (a standard
decoder; ``smat-ffn`` with its block-sparse FFN, ``smat-attn`` with
block-sparse attention scores on top).

The JAX package stacks the blocks on a leading axis and scans them; here
``Transformer.blocks`` is a ``ModuleList`` walked by a Python loop, and the
decode cache keeps the stacked layout (``{"k", "v"}: [n_layers, B, S, KV,
dh]``) so a layer's cache is a view into it.  ``forward``'s ``remat``
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
    if cfg.layout != "attn_mlp" or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"layout {cfg.layout!r} with input_mode {cfg.input_mode!r} is not "
            "ported yet (only attn_mlp over tokens)")


class Block(nn.Module):
    """One ``attn_mlp`` layer: pre-norm attention, then pre-norm MLP."""

    def __init__(self, cfg, *, dtype, device, generator=None,
                 seed_hint: int = 0):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.zeros(d, device=device))
        self.attn = L.init_attention(cfg, generator, dtype, device=device)
        self.ln2 = nn.Parameter(torch.zeros(d, device=device))
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
    one = L.init_attn_cache(cfg, batch, cache_len, _dtype(cfg),
                            window=cfg.sliding_window,
                            device=resolve_device(device))
    return {name: leaf[None].repeat(cfg.n_layers, *([1] * leaf.ndim))
            for name, leaf in one.items()}


# ============================================================ specs (no data)
def _block_specs(cfg: ModelConfig, i: int, device) -> dict:
    """Specs of layer ``i``: the JAX tree's ``blocks`` leaves at index
    ``i`` (``convert.params_from_jax``'s unstacking), plus each sparse
    layer's port buffers."""
    dtype, d = _dtype(cfg), cfg.d_model
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
    _check_layout(cfg)
    sc = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    shape = (cfg.n_layers, batch, sc, cfg.n_kv_heads, cfg.head_dim)
    return {"k": _spec(shape, _dtype(cfg)), "v": _spec(shape, _dtype(cfg))}


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
    """Returns (x, cache)."""
    a, c = L.attention(cfg, p.attn, L.rms_norm(x, p.ln1),
                       window=cfg.sliding_window, cache=cache, pos=pos,
                       slot_mask=slot_mask)
    x = x + a
    x = x + L.mlp(cfg, p.mlp, L.rms_norm(x, p.ln2),
                  seed_hints=(p.mlp.seed_hint,))
    return x, c


REMAT = ("none", "full")


def _remat_block(cfg: ModelConfig, blk: Block, x):
    """One block without a cache under activation checkpointing: its
    activations are recomputed in the backward (JAX ``remat="full"``)."""
    return torch_checkpoint.checkpoint(
        lambda x_: _apply_block(cfg, blk, x_, None, None)[0], x,
        use_reentrant=False)


def forward(cfg: ModelConfig, params: Transformer, batch_in, *, cache=None,
            pos=None, slot_mask=None, remat: str = "none"
            ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (logits, cache, aux_loss); the cache is updated in place.
    ``remat="full"`` checkpoints each block (training, no cache)."""
    if remat in ("dots", "names"):
        raise NotImplementedError(
            f"remat={remat!r} (a jax.checkpoint policy) is not ported yet; "
            f"use one of {REMAT}")
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r}; want one of {REMAT}")
    x = _embed(cfg, params, batch_in)
    for i, blk in enumerate(params.blocks):
        if remat == "full" and cache is None:
            x = _remat_block(cfg, blk, x)
            continue
        layer_cache = None if cache is None else \
            {name: leaf[i] for name, leaf in cache.items()}
        x, _ = _apply_block(cfg, blk, x, layer_cache, pos, slot_mask)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
    """One decode step: tokens [B], pos an int.  Writes the step's K/V into
    ``cache`` in place (only the rows where ``slot_mask`` [B] is True, when
    given).  Returns (logits [B, V], cache)."""
    logits, cache, _ = forward(cfg, params, {"tokens": tokens[:, None]},
                               cache=cache, pos=pos, slot_mask=slot_mask)
    return logits[:, 0], cache
