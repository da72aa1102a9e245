"""Model assembly: embeddings, the block stack, caches, and the forward /
prefill / decode entry points.

Layouts (the JAX package's):
  attn_mlp   — a standard decoder (the dense archs, the pixtral and
               musicgen backbones, ``smat-ffn`` with its block-sparse FFN,
               ``smat-attn`` with block-sparse attention scores on top);
  gemma_pair — a (local sliding-window + global) pair of attention + MLP
               halves a block, ``n_layers // 2`` blocks, post-norms on
               each half's attention and MLP outputs, logit softcaps;
  mla_moe    — DeepSeek MLA attention + a shared/routed MoE FFN;
  ssd        — Mamba2 (attention-free);
  zamba      — ``hybrid_n_units`` units of ``hybrid_unit_len`` Mamba2
               layers, each followed by ONE shared attention + MLP block
               (its weights reused by every unit), then ``hybrid_tail``
               Mamba2 layers.
Inputs: ``tokens`` [B, L]; ``tokens+patches`` (``patch_embeds`` [B, P, D]
put in front of the token embeddings; ``train_loss`` scores the text
positions only); ``codebooks`` (tokens [B, L, n_cb], the codebook
embeddings summed in order, logits [B, L, n_cb, V]).

The JAX package stacks the blocks on a leading axis and scans them; here
``Transformer.blocks`` is a ``ModuleList`` walked by a Python loop (for
``zamba``: ``units``, a list of lists, ``tail`` and ``shared_attn``), and
the decode cache keeps the stacked layout (``{"k", "v"}: [n_layers, B, S,
KV, dh]``; ``gemma_pair``: ``{"local": {k, v}, "global": {k, v}}`` over
the pairs, the local ring capped at the window; ``{"ckv", "krope"}:
[n_layers, B, S, r | rope]``; ``{"conv", "state"}: [n_layers, B, cw-1,
d_xbc | H, P, N]``; ``zamba``: ``{"units_ssd": [n_units, unit_len, ...],
"units_attn": [n_units, ...], "tail_ssd": [tail, ...]}``, each unit's use
of the shared block with an attention cache of its own) so a layer's cache
is a view into it.  ``forward``'s third value sums the layers' MoE
load-balance losses, as the JAX package's scan carries it.

Under a training mesh whose compute splits over ``model``
(``launch.constrain.model_split``; ``launch.steps.split_leaves``: every
layout and input) the residual stream is carried sequence-split:
``_embed`` looks up the rank's vocab slice of each table and
reduce-scatters the rows over the sequence (the codebook sum, the
``gemma_pair`` scale and the ``tokens+patches`` patch rows follow on the
rank's positions), the blocks' norms and the block-sparse FFN run on the
rank's positions (``layers.attention`` (both ``gemma_pair`` halves,
``zamba``'s shared block in every unit), ``layers.mla_attention``, a dense
``layers.mlp`` and ``moe.moe_ffn`` gather the sequence and compute their
shards; the Mamba2 mixer runs the gathered sequence on every rank and
keeps the rank's positions), and ``_head`` gathers the sequence for
vocab-split logits (softcapped as they are), whose cross-entropy
``lm_loss`` reduces over the model group; ``train_loss`` scores the text
positions of ``tokens+patches`` by their global positions.

Each group of parameters the JAX package's scan runs as one entry (a
block, ``zamba``'s shared block at each use, a Mamba2 layer of a unit or
the tail) and ``embed`` and the head run inside
``launch.constrain.gathered``: under the training mesh's per-layer
gather (``launch.steps``) their data-sharded weights are gathered there
and dropped after; elsewhere the mark does nothing.

``forward``'s ``remat`` replaces the JAX package's ``jax.checkpoint``
policies with ``torch.utils.checkpoint`` over each block: ``"full"``
recomputes everything; ``"dots"`` and ``"names"`` run a selective
checkpoint (``create_selective_checkpoint_contexts``) that saves the
outputs of the products without batch dimensions (``aten.mm``/``addmm``,
as ``dots_with_no_batch_dims_saveable``) or only the tensors tagged
``attn_ctx`` and ``moe_eout`` (``layers.checkpoint_name``).  ``zamba``
checkpoints its tail only, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import meta_spec as _spec
from repro_torch.core.sparse_linear import sparse_linear_specs
from repro_torch.launch.constrain import (BATCH, MODEL, ModelSplit,
                                          constrain, gather, gathered,
                                          local_seq, model_split, pmax_model,
                                          psum_data, reduce, scatter)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

LAYOUTS = ("attn_mlp", "gemma_pair", "mla_moe", "ssd", "zamba")
INPUT_MODES = ("tokens", "tokens+patches", "codebooks")


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
    if cfg.layout not in LAYOUTS:
        raise ValueError(f"unknown layout {cfg.layout!r}; want one of "
                         f"{LAYOUTS}")
    if cfg.input_mode not in INPUT_MODES:
        raise ValueError(f"unknown input_mode {cfg.input_mode!r}; want one "
                         f"of {INPUT_MODES}")


@functools.lru_cache(maxsize=None)
def _view(cfg: ModelConfig, layout: str) -> ModelConfig:
    """``cfg`` read as another layout: ``zamba``'s Mamba2 layers run as
    ``ssd`` blocks and its shared block as an ``attn_mlp`` block without
    a window (the JAX package's shared block passes none)."""
    if layout == "attn_mlp":
        return dataclasses.replace(cfg, layout=layout, sliding_window=None)
    return dataclasses.replace(cfg, layout=layout)


def _n_repeats(cfg: ModelConfig) -> int:
    """Blocks of the stack: a ``gemma_pair`` block holds two layers."""
    return cfg.n_layers // 2 if cfg.layout == "gemma_pair" else cfg.n_layers


class GemmaHalf(nn.Module):
    """One half of a ``gemma_pair`` block: pre-norm attention with a
    post-norm on its output (``ln1``/``attn``/``ln1_post``), then pre-norm
    MLP with a post-norm (``ln2``/``mlp``/``ln2_post``)."""

    def __init__(self, cfg, *, dtype, device, generator=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.zeros(d, device=device))
        self.ln1_post = nn.Parameter(torch.zeros(d, device=device))
        self.attn = L.init_attention(cfg, generator, dtype, device=device)
        self.ln2 = nn.Parameter(torch.zeros(d, device=device))
        self.ln2_post = nn.Parameter(torch.zeros(d, device=device))
        self.mlp = L.init_mlp(cfg, generator, dtype, device=device)


class Block(nn.Module):
    """One block, its parameters named as the JAX package's ``blocks``
    tree: ``attn_mlp`` (pre-norm attention ``ln1``/``attn``, then pre-norm
    MLP ``ln2``/``mlp``), ``gemma_pair`` (``local`` and ``global``
    halves, ``GemmaHalf``), ``mla_moe`` (``ln1``/``mla``, then ``ln2``/
    ``moe``) or ``ssd`` (``ln``/``ssd``)."""

    def __init__(self, cfg, *, dtype, device, generator=None,
                 seed_hint: int = 0):
        super().__init__()
        d = cfg.d_model
        if cfg.layout == "ssd":
            self.ln = nn.Parameter(torch.zeros(d, device=device))
            self.ssd = S.init_ssd(cfg, generator, dtype, device=device)
            return
        if cfg.layout == "gemma_pair":
            for kind in ("local", "global"):
                self.add_module(kind, GemmaHalf(cfg, dtype=dtype,
                                                device=device,
                                                generator=generator))
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
    always come from their numpy seeds, as in the JAX package.  ``embed``
    is [V, D] and ``lm_head`` [D, V] ([n_cb, V, D] and [n_cb, D, V] for
    ``codebooks``)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        _check_layout(cfg)
        self.cfg = cfg
        dtype, d, V = _dtype(cfg), cfg.d_model, cfg.vocab_size
        cb = (cfg.n_codebooks,) if cfg.input_mode == "codebooks" else ()
        self.final_norm = nn.Parameter(torch.zeros(d, device=device))
        self.embed = L._weight(cb + (V, d), 0.02, dtype, device, generator)
        self.lm_head = L._weight(cb + (d, V), d ** -0.5, dtype, device,
                                 generator)
        if cfg.layout == "zamba":
            ssd, kw = _view(cfg, "ssd"), dict(dtype=dtype, device=device,
                                              generator=generator)
            self.units = nn.ModuleList(
                nn.ModuleList(Block(ssd, **kw)
                              for _ in range(cfg.hybrid_unit_len))
                for _ in range(cfg.hybrid_n_units))
            self.tail = nn.ModuleList(Block(ssd, **kw)
                                      for _ in range(cfg.hybrid_tail))
            self.shared_attn = Block(_view(cfg, "attn_mlp"), **kw)
            return
        self.blocks = nn.ModuleList(
            Block(cfg, dtype=dtype, device=device, generator=generator,
                  seed_hint=i) for i in range(_n_repeats(cfg)))

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


def _stacked(tree, *lead):
    """``tree``'s leaves repeated over the leading dims ``lead`` (each copy
    its own storage)."""
    if isinstance(tree, dict):
        return {k: _stacked(v, *lead) for k, v in tree.items()}
    return tree[(None,) * len(lead)].repeat(*lead, *([1] * tree.ndim))


def _layer(tree, *index):
    """The views of a stacked cache tree at ``index`` (a layer's cache)."""
    if isinstance(tree, dict):
        return {k: _layer(v, *index) for k, v in tree.items()}
    return tree[index]


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device="cuda"):
    """Decode caches for the whole network, stacked over layers."""
    _check_layout(cfg)
    device, dtype = resolve_device(device), _dtype(cfg)
    if cfg.layout == "zamba":
        ssd = S.init_ssd_cache(cfg, batch, dtype, device=device)
        attn = L.init_attn_cache(cfg, batch, cache_len, dtype, device=device)
        return {"units_ssd": _stacked(ssd, cfg.hybrid_n_units,
                                      cfg.hybrid_unit_len),
                "units_attn": _stacked(attn, cfg.hybrid_n_units),
                "tail_ssd": _stacked(ssd, cfg.hybrid_tail)}
    if cfg.layout == "mla_moe":
        one = L.init_mla_cache(cfg, batch, cache_len, dtype, device=device)
    elif cfg.layout == "ssd":
        one = S.init_ssd_cache(cfg, batch, dtype, device=device)
    elif cfg.layout == "gemma_pair":
        one = {"local": L.init_attn_cache(cfg, batch, cache_len, dtype,
                                          window=cfg.sliding_window,
                                          device=device),
               "global": L.init_attn_cache(cfg, batch, cache_len, dtype,
                                           device=device)}
    else:
        one = L.init_attn_cache(cfg, batch, cache_len, dtype,
                                window=cfg.sliding_window, device=device)
    return _stacked(one, _n_repeats(cfg))


# ============================================================ specs (no data)
def _attn_mlp_specs(cfg: ModelConfig, seed_hint: int, device) -> dict:
    """Specs of an ``attn_mlp`` block built with ``seed_hint`` (its sparse
    layers' pattern seeds): ``ln1``/``attn``/``ln2``/``mlp``."""
    dtype, d = _dtype(cfg), cfg.d_model
    h, kv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    attn = {"wq": _spec((d, h * hd), dtype), "wk": _spec((d, kv * hd), dtype),
            "wv": _spec((d, kv * hd), dtype), "wo": _spec((h * hd, d), dtype)}
    if cfg.qkv_bias:
        attn.update(bq=_spec((h * hd,), dtype), bk=_spec((kv * hd,), dtype),
                    bv=_spec((kv * hd,), dtype))
    spec = cfg.ffn_sparsity
    if spec is not None:
        seed = L.mlp_seed(seed_hint)
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


def _block_specs(cfg: ModelConfig, i: int, device) -> dict:
    """Specs of block ``i``: the JAX tree's ``blocks`` leaves at index
    ``i`` (``convert.params_from_jax``'s unstacking), plus each sparse
    layer's port buffers."""
    if cfg.layout in ("mla_moe", "ssd"):        # no sparse layer in these
        return _module_specs(Block(cfg, dtype=_dtype(cfg), device="meta"))
    if cfg.layout == "gemma_pair":              # every half's MLP: hint 0
        post = {"ln1_post": _spec((cfg.d_model,), torch.float32),
                "ln2_post": _spec((cfg.d_model,), torch.float32)}
        return {kind: {**_attn_mlp_specs(cfg, 0, device), **post}
                for kind in ("local", "global")}
    return _attn_mlp_specs(cfg, i, device)


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
    blocks (``zamba``: ``units`` into a list of lists, ``tail`` into a
    list), as ``convert.params_from_jax`` reads it, so ``flat_specs`` of
    it has ``Transformer.state_dict()``'s keys.  Sparse layers take their
    true structure metas (their numpy pattern seeds), which size the
    port's schedule buffers.  ``device`` only keys ``shards="auto"``."""
    _check_layout(cfg)
    dtype, d, V = _dtype(cfg), cfg.d_model, cfg.vocab_size
    cb = (cfg.n_codebooks,) if cfg.input_mode == "codebooks" else ()
    out = {"final_norm": _spec((d,), torch.float32),
           "embed": _spec(cb + (V, d), dtype),
           "lm_head": _spec(cb + (d, V), dtype)}
    if cfg.layout == "zamba":
        def ssd():
            return _module_specs(Block(_view(cfg, "ssd"), dtype=dtype,
                                       device="meta"))
        out["units"] = [[ssd() for _ in range(cfg.hybrid_unit_len)]
                        for _ in range(cfg.hybrid_n_units)]
        out["tail"] = [ssd() for _ in range(cfg.hybrid_tail)]
        out["shared_attn"] = _attn_mlp_specs(cfg, 0, device)
        return out
    out["blocks"] = [_block_specs(cfg, i, device)
                     for i in range(_n_repeats(cfg))]
    return out


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
@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """``sqrt(d_model)`` rounded to ``dtype`` first, as the JAX package
    multiplies by ``jnp.asarray(d ** 0.5, x.dtype)`` (68.0 for 4608 in
    bf16); its product with a bf16 activation is exact in float32, so the
    result is rounded once, as JAX's."""
    return float(torch.tensor(d_model ** 0.5, dtype=dtype))


def _lookup(table: torch.Tensor, ids: torch.Tensor,
            split: ModelSplit | None) -> torch.Tensor:
    """``table``'s rows at ``ids``.  Under ``split`` ``table`` is this
    rank's vocab slice [V/m, D], holding ids ``index * V/m`` onwards, and
    the ids outside it read zero rows."""
    if split is None:
        return table[ids]
    rows = table.shape[0]
    ids = ids - split.index * rows
    hit = (ids >= 0) & (ids < rows)
    return torch.where(hit[..., None], table[ids.clamp(0, rows - 1)], 0)


def _embed(cfg: ModelConfig, params, batch_in) -> torch.Tensor:
    """The residual stream's first value: the token rows (``codebooks``:
    each codebook's rows, summed in order in the model dtype, the JAX
    package's Python ``sum``), times ``sqrt(d_model)`` for ``gemma_pair``,
    with ``tokens+patches``' ``patch_embeds`` in front.

    Under a split over ``model`` it is this rank's positions of that
    stream.  A vocab-split ``embed`` looks up every position in the rank's
    slice (zero rows outside it), and the ranks' rows, each table's
    apart, are reduce-scattered over the sequence, with zero rows at the
    patch positions.  Each sum has one nonzero term, so the rows are
    exact; a replicated ``embed`` takes the rank's chunk of its rows.  The
    codebook sum, the scale and the patch rows then act on the rank's
    positions as they do unsplit, so the rank's rows equal the unsplit
    stream's bit for bit."""
    tokens = batch_in["tokens"]
    table = params.embed
    split = model_split()
    by_vocab = split if split is not None and \
        table.shape[-2] < cfg.vocab_size else None
    if cfg.input_mode == "codebooks":
        # tokens [B, L, n_cb]: one table a codebook
        rows = [_lookup(table[c], tokens[..., c], by_vocab)
                for c in range(cfg.n_codebooks)]
    else:
        rows = [_lookup(table, tokens, by_vocab)]               # [B, L, D]
    pe = batch_in.get("patch_embeds") \
        if cfg.input_mode == "tokens+patches" else None
    n_patch = 0 if pe is None else pe.shape[1]
    if split is not None:
        x = F.pad(torch.stack(rows, 2), (0, 0, 0, 0, n_patch, 0))
        rows = (local_seq(x, 1) if by_vocab is None else
                scatter(x, 1)).unbind(2)
    x = rows[0]
    for r in rows[1:]:
        x = x + r
    if cfg.layout == "gemma_pair":
        x = x * _embed_scale(cfg.d_model, x.dtype)
    if pe is None:
        return x
    pe = pe.to(x.dtype)                                     # [B, P, D]
    if split is None:
        return torch.cat([pe, x], dim=1)
    # the patch rows at the rank's positions that hold them
    n = x.shape[1]
    pos = split.index * n + torch.arange(n, device=x.device)
    mine = local_seq(F.pad(pe, (0, 0, 0, split.size * n - n_patch)), 1)
    return torch.where((pos < n_patch)[:, None], mine, x)


def _head(cfg: ModelConfig, params, x) -> torch.Tensor:
    x = L.rms_norm(x, params.final_norm)
    if params.lm_head.shape[-1] < cfg.vocab_size:
        x = gather(x, 1)        # vocab-split logits [B, L, (n_cb,) V/m]
    if cfg.input_mode == "codebooks":
        logits = torch.einsum("bld,cdv->blcv", x, params.lm_head)
    else:
        logits = x @ params.lm_head
    return L.softcap(logits.float(), cfg.final_logit_softcap)


def _attn_mlp(cfg, p, x, cache, pos, slot_mask, window):
    """Pre-norm attention, then pre-norm MLP (an ``attn_mlp`` block)."""
    a, c = L.attention(cfg, p.attn, L.rms_norm(x, p.ln1), window=window,
                       cache=cache, pos=pos, slot_mask=slot_mask)
    x = x + a
    x = x + L.mlp(cfg, p.mlp, L.rms_norm(x, p.ln2),
                  seed_hints=(p.mlp.seed_hint,))
    return x, c


def _apply_block(cfg: ModelConfig, p: Block, x, cache, pos, slot_mask=None):
    """Returns (x, cache, aux): ``aux`` is the layer's MoE load-balance
    loss (0 for the other layouts)."""
    if x.shape[1] > 1:
        # sequence-parallel carry (the JAX package's Megatron-SP constraint)
        x = constrain(x, BATCH, MODEL)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.layout == "ssd":
        # under a split the mixer, sequential in the positions, runs the
        # gathered sequence on every rank, which keeps its own positions
        # (the replicated leaves' gradients meet in ``psum_model``)
        y, c = S.ssd_block(cfg, p.ssd, gather(L.rms_norm(x, p.ln), 1),
                           cache=cache, pos=pos, slot_mask=slot_mask)
        return x + local_seq(y, 1), c, aux
    if cfg.layout == "mla_moe":
        a, c = L.mla_attention(cfg, p.mla, L.rms_norm(x, p.ln1), cache=cache,
                               pos=pos, slot_mask=slot_mask)
        x = x + a
        y, aux = M.moe_ffn(cfg, p.moe, L.rms_norm(x, p.ln2),
                           dispatch=cfg.moe_dispatch)
        return x + y, c, aux
    if cfg.layout == "gemma_pair":
        for kind, window in (("local", cfg.sliding_window), ("global", None)):
            h = getattr(p, kind)
            a, _ = L.attention(cfg, h.attn, L.rms_norm(x, h.ln1),
                               window=window,
                               cache=None if cache is None else cache[kind],
                               pos=pos, slot_mask=slot_mask)
            x = x + L.rms_norm(a, h.ln1_post)
            m = L.mlp(cfg, h.mlp, L.rms_norm(x, h.ln2),
                      seed_hints=(h.mlp.seed_hint,))
            x = x + L.rms_norm(m, h.ln2_post)
        return x, cache, aux
    x, c = _attn_mlp(cfg, p, x, cache, pos, slot_mask, cfg.sliding_window)
    return x, c, aux


REMAT = ("none", "full", "dots", "names")
# the tensors ``remat="names"`` saves (``layers.checkpoint_name`` tags)
SAVED_NAMES = ("attn_ctx", "moe_eout")
# products without batch dimensions: ``remat="dots"`` saves their outputs
_DOTS = ("mm", "addmm")


def _remat_policy(remat: str):
    """The selective checkpoint's policy of ``remat`` ("dots" or
    "names"): save what it names, recompute the rest."""
    CP = torch_checkpoint.CheckpointPolicy
    if remat == "dots":
        saved = {getattr(torch.ops.aten, op).default for op in _DOTS}

        def policy(ctx, op, *args, **kwargs):
            return CP.MUST_SAVE if op in saved else CP.PREFER_RECOMPUTE
    else:
        def policy(ctx, op, *args, **kwargs):
            return CP.MUST_SAVE if op == L.CHECKPOINT_NAME_OP and \
                args[1] in SAVED_NAMES else CP.PREFER_RECOMPUTE
    return policy


def _remat_block(cfg: ModelConfig, blk: Block, x, remat: str):
    """One block without a cache under activation checkpointing (the JAX
    package's ``jax.checkpoint`` of the block, with ``remat``'s policy).
    Returns (x, aux)."""
    def run(x_):                     # the recompute gathers the block too
        with gathered(blk):
            x_, _, aux = _apply_block(cfg, blk, x_, None, None)
        return x_, aux
    kw = {}
    if remat != "full":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _remat_policy(remat))
    return torch_checkpoint.checkpoint(run, x, use_reentrant=False, **kw)


def _run_stack(cfg, blocks, x, cache, pos, slot_mask, remat, lead=()):
    """The blocks in order, block ``i`` on the cache at ``lead + (i,)``;
    returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(blocks):
        if remat != "none" and cache is None:
            x, a = _remat_block(cfg, blk, x, remat)
        else:
            c = None if cache is None else _layer(cache, *lead, i)
            with gathered(blk):
                x, _, a = _apply_block(cfg, blk, x, c, pos, slot_mask)
        aux = aux + a
    return x, aux


def _zamba_forward(cfg, params, x, cache, pos, slot_mask, remat):
    """Each unit's Mamba2 layers, then the shared attention + MLP block
    (the same weights in every unit, the unit's own attention cache); the
    tail after the last unit.  Only the tail is checkpointed."""
    ssd = _view(cfg, "ssd")
    for u, unit in enumerate(params.units):
        x, _ = _run_stack(ssd, unit, x, None if cache is None else
                          cache["units_ssd"], pos, slot_mask, "none",
                          lead=(u,))
        c = None if cache is None else _layer(cache["units_attn"], u)
        with gathered(params.shared_attn):          # at each use
            x, _ = _attn_mlp(cfg, params.shared_attn, x, c, pos, slot_mask,
                             None)
    return _run_stack(ssd, params.tail, x, None if cache is None else
                      cache["tail_ssd"], pos, slot_mask, remat)


def forward(cfg: ModelConfig, params: Transformer, batch_in, *, cache=None,
            pos=None, slot_mask=None, remat: str = "none"
            ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (logits, cache, aux_loss); the cache is updated in place.
    ``aux_loss`` sums the layers' MoE load-balance losses.  ``remat``
    checkpoints each block (training, no cache) under one of ``REMAT``'s
    policies."""
    if remat not in REMAT:
        raise ValueError(f"unknown remat {remat!r}; want one of {REMAT}")
    with gathered(params, ("embed",)):
        x = constrain(_embed(cfg, params, batch_in), BATCH)
    if cfg.layout == "zamba":
        x, aux = _zamba_forward(cfg, params, x, cache, pos, slot_mask, remat)
    else:
        x, aux = _run_stack(cfg, params.blocks, x, cache, pos, slot_mask,
                            remat)
    with gathered(params, ("lm_head", "final_norm")):
        logits = _head(cfg, params, x)
    return logits, cache, aux


# ================================================================ entry points
def lm_loss(cfg: ModelConfig, logits, labels) -> torch.Tensor:
    """Next-token CE.  labels already shifted; -100 = ignore.  Under a
    training mesh whose data group has more than one rank
    (``launch.constrain.data_parallel``) it is this rank's share: its rows'
    summed NLL over the global batch's count of valid labels, so that the
    shares sum to the loss of the global batch, as GSPMD's mean is.

    Under a split over ``model`` every rank of the model group returns the
    same loss.  Vocab-split logits [B, L, V/m] give each position's NLL
    from the row max, the sum of exponentials and the target logit, each
    reduced over the model group (no rank holds [B, L, V]); logits of this
    rank's positions [B, L/m, V] give its positions' share, summed over the
    group."""
    split = model_split()
    if split is not None:
        valid = labels >= 0
        count, = psum_data([valid.sum()])
        if logits.shape[-1] == cfg.vocab_size:
            mine = local_seq(labels, 1)
            nll = _nll(logits, mine.clamp_min(0).long())
            return reduce((nll * (mine >= 0)).sum() / count.clamp_min(1))
        nll = _split_nll(logits, labels.clamp_min(0).long(), split)
        return (nll * valid).sum() / count.clamp_min(1)
    valid = labels >= 0
    lab = labels.clamp_min(0).long()
    nll = _nll(logits, lab)
    count, = psum_data([valid.sum()])
    return (nll * valid).sum() / count.clamp_min(1)


def _nll(logits, lab) -> torch.Tensor:
    lp = torch.log_softmax(logits, dim=-1)
    return -lp.gather(-1, lab[..., None])[..., 0]


def _split_nll(logits, lab, split: ModelSplit) -> torch.Tensor:
    """-log softmax at ``lab`` of logits split over the vocab: this rank's
    slice [..., V/m] holds ids ``index * V/m`` onwards."""
    rows = logits.shape[-1]
    mx = pmax_model(logits.detach().amax(dim=-1))
    total = reduce(torch.exp(logits - mx[..., None]).sum(dim=-1))
    ids = lab - split.index * rows
    hit = (ids >= 0) & (ids < rows)
    mine = logits.gather(-1, ids.clamp(0, rows - 1)[..., None])[..., 0]
    target = reduce(torch.where(hit, mine, 0))
    return torch.log(total) + mx - target


def train_loss(cfg: ModelConfig, params: Transformer, batch_in,
               remat: str = "full"):
    """Returns (loss, {"lm_loss", "aux_loss"}); ``batch_in`` holds
    ``tokens`` and shifted ``labels`` (-100 = ignore), and for
    ``tokens+patches`` the ``patch_embeds``, whose positions the loss
    leaves out.  Under a data-parallel mesh each term is this rank's share
    (``lm_loss``, ``moe._route``): the shares sum to the global loss."""
    logits, _, aux = forward(cfg, params, batch_in, remat=remat)
    labels = batch_in["labels"]
    if cfg.input_mode == "tokens+patches":
        n_patch = cfg.patch_tokens
        if model_split() is not None and logits.shape[-1] == cfg.vocab_size:
            # logits of this rank's positions: the patch positions score
            # nothing (their labels -100), wherever the chunk falls
            labels = F.pad(labels, (n_patch, 0), value=-100)
        else:
            logits = logits[:, n_patch:]
    loss = lm_loss(cfg, logits, labels)
    return loss + 0.01 * aux, {"lm_loss": loss, "aux_loss": aux}


def prefill(cfg: ModelConfig, params: Transformer, batch_in, cache_len: int):
    """Build decode caches from a prompt (its ``patch_embeds`` in front,
    for ``tokens+patches``).  Returns (logits, cache)."""
    B = batch_in["tokens"].shape[0]
    cache = init_cache(cfg, B, cache_len, device=params.embed.device)
    logits, cache, _ = forward(cfg, params, batch_in, cache=cache, pos=0)
    return logits, cache


def decode_step(cfg: ModelConfig, params: Transformer, cache, tokens,
                pos: int, slot_mask=None):
    """One decode step: tokens [B] ([B, n_cb] for ``codebooks``), pos an
    int.  Writes the step's K/V (MLA: latent; SSD: conv window and state)
    into ``cache`` in place (only the rows where ``slot_mask`` [B] is True,
    when given).  Returns (logits [B, V] ([B, n_cb, V]), cache)."""
    logits, cache, _ = forward(cfg, params, {"tokens": tokens[:, None]},
                               cache=cache, pos=pos, slot_mask=slot_mask)
    return logits[:, 0], cache
