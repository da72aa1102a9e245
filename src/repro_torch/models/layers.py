"""Transformer layer components: norms, RoPE, GQA attention (sliding window,
logit softcap, QKV bias, or block-sparse scores on a static BCSR mask:
``cfg.attn_sparsity``) and the gated MLP, dense or block-sparse (the paper's
technique as a drop-in FFN).

Conventions (those of the JAX package):
  * activations are [B, L, D]; decode caches are ring buffers written at
    ``pos % cache_len``;
  * attention math accumulates in float32;
  * the functions take the layer's module (``Attention``, ``MLP``) as ``p``
    and read its parameters by the JAX package's names.

Unlike the JAX package, the decode cache is updated IN PLACE: prefill and
decode write the new K/V into the cache tensors they are given and return
the same dict.  With a ``slot_mask``, decode writes only the masked batch
rows — the serving engine's per-slot merge, done without a copy of the
whole cache per step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core.sparse_linear import (SparseLinear,
                                            apply_sparse_linear,
                                            init_sparse_linear,
                                            merge_sparse_metas,
                                            sparse_linear_meta)
from repro_torch.obs import shapemon

# chunk size for q-blocked (O(L*chunk) memory) attention
Q_CHUNK = 1024
NEG_INF = -2.0e38


# ------------------------------------------------------------------ basics
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _rope_freqs(head_dim: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x [..., L, H, dh]; positions [..., L] int (broadcastable).  Split
    halves, not interleaved pairs."""
    dh = x.shape[-1]
    freqs = _rope_freqs(dh, theta, x.device)                  # [dh/2]
    ang = positions[..., None].float() * freqs                # [..., L, dh/2]
    sin, cos = ang.sin()[..., None, :], ang.cos()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _dense(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return y


def _weight(shape, scale, dtype, device, generator):
    """A weight drawn as the JAX package draws it (standard normal in f32,
    scaled, cast), or left uninitialised when ``generator`` is None (the
    weights are then loaded, as ``convert.params_from_jax`` does)."""
    if generator is None:
        w = torch.empty(shape, dtype=dtype, device=device)
    else:
        w = (torch.randn(shape, generator=generator, dtype=torch.float32,
                         device=device) * scale).to(dtype)
    return nn.Parameter(w)


# ================================================================= attention
class Attention(nn.Module):
    def __init__(self, cfg, *, dtype, device, generator=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        s = d ** -0.5
        self.wq = _weight((d, h * hd), s, dtype, device, generator)
        self.wk = _weight((d, kv * hd), s, dtype, device, generator)
        self.wv = _weight((d, kv * hd), s, dtype, device, generator)
        self.wo = _weight((h * hd, d), (h * hd) ** -0.5, dtype, device,
                          generator)
        for name, n in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            self.register_parameter(name, nn.Parameter(torch.zeros(
                n, dtype=dtype, device=device)) if cfg.qkv_bias else None)


def init_attention(cfg, generator, dtype, *, device) -> Attention:
    return Attention(cfg, dtype=dtype, device=device, generator=generator)


def _mask_bias(q_pos, k_pos, window):
    """[..., Lq, Sk] additive mask: causal + optional sliding window +
    validity (k_pos >= 0)."""
    ok = (k_pos[..., None, :] <= q_pos[..., :, None]) & \
         (k_pos[..., None, :] >= 0)
    if window is not None:
        ok &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return torch.where(ok, 0.0, NEG_INF)


def _sdpa(q, k, v, bias, cap, scale):
    """q [B,Lq,H,dh] k [B,S,KV,dh] v [B,S,KV,dv] bias [B,Lq,S]
    -> [B,Lq,H,dv]; scores and softmax in float32."""
    B, Lq, H, dh = q.shape
    KV = k.shape[2]
    dv = v.shape[-1]
    rep = H // KV
    qg = q.reshape(B, Lq, KV, rep, dh)
    scores = torch.einsum("blgrd,bsgd->bgrls", qg.float(), k.float()) * scale
    scores = softcap(scores, cap)
    scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bgrls,bsgd->blgrd", probs, v.float())
    return ctx.reshape(B, Lq, H, dv)


def _sparse_mask(cfg, window):
    """Effective mask spec of the block-sparse attention path: the config's
    static pattern, intersected with the layer's sliding window when one is
    set."""
    mask = cfg.attn_sparsity.mask
    if window is not None:
        mask = dataclasses.replace(mask, window_cap=int(window))
    return mask


def _decode_pages(cfg, window, cache_len):
    """Static paged-decode resolution for one attention layer, as the JAX
    package decides it: the mask page table ``(pages, live)`` where the
    paged KV path applies, else None (dense-bias decode).
    ``AttnSparsitySpec.paged_decode``: "auto" requires a strict page saving
    (``max_bpr < n_pages``), "force" only that pages tile the cache, "off"
    disables.  Where this returns a table, ``attention`` decodes through
    ``_paged_decode``."""
    sparse = getattr(cfg, "attn_sparsity", None)
    if sparse is None:
        return None
    mode = getattr(sparse, "paged_decode", "auto")
    if mode == "off":
        return None
    w = sparse.block[1]
    if cache_len % w != 0:          # pages must tile the KV ring exactly
        return None
    from repro_torch.models import attention as A
    pages, live, meta = A.decode_page_table(
        _sparse_mask(cfg, window), cache_len, tuple(sparse.block))
    if meta.max_bpr <= 0:
        return None
    if mode != "force" and meta.max_bpr >= cache_len // w:
        return None                 # no page saving: keep the dense bias
    return pages, live


@shapemon.monitor(name="models.paged_decode")
def _paged_decode(cfg, q, kc, vc, pos, window, cap, scale, *,
                  pages, live):
    """One-token decode attention reading KV through the mask page table
    (``attention.decode_page_table``) instead of biasing the dense cache:
    the twin of the JAX package's ``_paged_decode``.

    ``pages`` [nbr, P] (int64) and ``live`` [nbr, P] (bool) lie on the
    cache's device (``attention.decode_page_tensors`` caches them per
    device, so a call copies nothing from the host).  Only the P pages of
    block-row ``pos // block_h`` are gathered; softmax combines them as a
    SEQUENTIAL per-page fold in ascending page order (exact max, then each
    page's partial context and denominator added page by page, the
    denominator riding as one extra column of the context so a page costs
    one add).  A page absent from the table contributes exactly 0.0 and
    never attains the max, and inserting exact zeros into a sequential add
    chain changes no bit — so in float32 this path equals, bit for bit,
    the same call over the FULL page table (``arange(n_pages)`` in every
    row, all live).  That needs every per-page term to come out the same
    whatever P is: the scores and partial contexts are elementwise
    products summed over one axis (``dh``, then ``w``), whose reduction
    order depends on that axis alone, not a batched matmul, whose kernel
    choice may depend on the batch count.  Never fold with ``sum`` or
    ``cumsum`` (not a sequential chain on the card).

    Positions are taken as ``page * w + offset``: the paged path assumes
    the ring has not wrapped (``pos < cache_len``), which the serving
    scheduler enforces at admission (``len(prompt) + max_new_tokens <=
    cache_len``).  ``pos`` is a Python int; ``shapemon`` counts the input
    signatures (shapes, dtypes, devices, types), so a decode run at one
    shape counts one whatever positions it walks."""
    from repro_torch.models import attention as A
    spec = _sparse_mask(cfg, window)
    B, _, H, dh = q.shape
    Sc, KV = kc.shape[1], kc.shape[2]
    h, w = cfg.attn_sparsity.block
    n_pages = Sc // w
    row = min(max(pos // h, 0), pages.shape[0] - 1)
    cols, alive = pages[row], live[row]                   # [P] views
    P = int(cols.shape[0])
    kp = kc.view(B, n_pages, w, KV, dh).index_select(1, cols)  # [B,P,w,KV,dh]
    vp = vc.view(B, n_pages, w, KV, dh).index_select(1, cols)
    k_pos = (cols[:, None] * w + torch.arange(
        w, dtype=cols.dtype, device=cols.device)).reshape(-1)    # [P*w]
    q_pos = torch.full((1,), pos, dtype=torch.int64, device=q.device)
    bias = (_mask_bias(q_pos, k_pos, window) +
            A.decode_mask_bias(spec, q_pos, k_pos))[0].reshape(P, w)
    bias = torch.where(alive[:, None], bias, NEG_INF)
    rep = H // KV
    qg = q.reshape(B, KV, rep, dh).float()                # L == 1 squeezed
    # bf16 operands are widened inside the products (exactly)
    scores = (kp[:, :, :, :, None, :] * qg[:, None, None]).sum(-1) * scale
    scores = softcap(scores, cap)                         # [B,P,w,KV,rep]
    biased = scores + bias[None, :, :, None, None]
    m = biased.amax(dim=(1, 2), keepdim=True)             # exact any order
    z = torch.exp(biased - m)
    partial = (z[..., None] * vp[:, :, :, :, None, :]).sum(2)  # [B,P,KV,rep,dh]
    terms = torch.cat([partial, z.sum(2)[..., None]], dim=-1)  # + page sum
    acc = torch.zeros_like(terms[:, 0])
    for p in range(P):      # sequential add chain, ascending page order
        acc = acc + terms[:, p]
    ctx = acc[..., :dh] / acc[..., dh:]
    return ctx.reshape(B, 1, H, dh)


def _sparse_attention(cfg, q, k, v, window, cap, scale):
    """Full-sequence attention through ``models.attention``: SDDMM scores
    on the static BCSR mask, masked block softmax, SpMM context (or kernel
    B5 for all three).  Replaces ``_causal_attention`` when
    ``cfg.attn_sparsity`` is set."""
    from repro_torch.models import attention as A
    spec = dataclasses.replace(cfg.attn_sparsity,
                               mask=_sparse_mask(cfg, window))
    rep = q.shape[2] // k.shape[2]
    if rep > 1:                     # GQA: expand KV heads for per-head ops
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return A.block_sparse_attention(q, k, v, spec, scale=scale, cap=cap)


def attention(cfg, p, x, *, window=None, cache=None, pos=None,
              rope_theta=None, slot_mask=None):
    """Returns (y, cache).  Modes:
      train:    cache None, pos None — full causal self-attention.
      prefill:  cache dict (zeroed, len >= L), pos = 0 — causal + cache write.
      decode:   cache dict, L == 1, pos = current position (int).
    The cache is written in place; in decode only the rows where
    ``slot_mask`` [B] is True (all rows when it is None).

    With ``cfg.attn_sparsity`` set, train/prefill score the static BCSR
    mask (``models.attention``) and decode applies the SAME mask spec:
    through the paged KV gather (``_paged_decode``) where the spec's
    ``paged_decode`` resolves a page table, else as a positional bias."""
    B, L, D = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    theta = rope_theta or cfg.rope_theta
    q = _dense(x, p.wq, p.bq).reshape(B, L, h, dh)
    k = _dense(x, p.wk, p.bk).reshape(B, L, kv, dh)
    v = _dense(x, p.wv, p.bv).reshape(B, L, kv, dh)

    positions = torch.arange(L, dtype=torch.int64, device=x.device)
    if cache is not None and pos is not None:
        positions = positions + pos
    positions = positions[None, :].expand(B, L)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)

    scale = dh ** -0.5
    cap = cfg.attn_logit_softcap

    sparse = cfg.attn_sparsity
    if cache is None:
        if sparse is not None:
            ctx = _sparse_attention(cfg, q, k, v, window, cap, scale)
        else:
            ctx = _causal_attention(q, k, v, window, cap, scale)
    elif L > 1:                              # prefill into empty cache
        kc, vc = cache["k"], cache["v"]
        Sc = kc.shape[1]
        n = min(L, Sc)
        kc[:, :n] = k[:, -Sc:].to(kc.dtype)
        vc[:, :n] = v[:, -Sc:].to(vc.dtype)
        if sparse is not None:
            ctx = _sparse_attention(cfg, q, k, v, window, cap, scale)
        else:
            ctx = _causal_attention(q, k, v, window, cap, scale)
    else:                                    # decode one token
        kc, vc = cache["k"], cache["v"]
        Sc = kc.shape[1]
        slot = pos % Sc
        k_new, v_new = k[:, 0].to(kc.dtype), v[:, 0].to(vc.dtype)
        if slot_mask is not None:
            keep = slot_mask[:, None, None]
            k_new = torch.where(keep, k_new, kc[:, slot])
            v_new = torch.where(keep, v_new, vc[:, slot])
        kc[:, slot] = k_new
        vc[:, slot] = v_new
        table = None if sparse is None else _decode_pages(cfg, window, Sc)
        if table is not None:
            # paged KV: gather only the mask row's pages (serve.paged_kv)
            from repro_torch.models import attention as A
            pages, live = A.decode_page_tensors(
                _sparse_mask(cfg, window), Sc, tuple(sparse.block), kc.device)
            ctx = _paged_decode(cfg, q, kc, vc, pos, window, cap, scale,
                                pages=pages, live=live)
        else:
            j = torch.arange(Sc, dtype=torch.int64, device=x.device)
            k_pos = pos - ((pos - j) % Sc)   # ring-buffer slot positions
            q_pos = torch.full((1,), pos, dtype=torch.int64, device=x.device)
            bias = _mask_bias(q_pos, k_pos, window)      # [1, Sc]
            if sparse is not None:
                # the decode twin of the block-sparse score mask
                from repro_torch.models import attention as A
                bias = bias + A.decode_mask_bias(_sparse_mask(cfg, window),
                                                 q_pos, k_pos)
            ctx = _sdpa(q, kc, vc, bias[None].expand(B, 1, Sc), cap, scale)

    y = _dense(ctx.reshape(B, L, h * dh).to(x.dtype), p.wo)
    return y, cache


def _causal_attention(q, k, v, window, cap, scale):
    """Full causal attention, q-chunked above Q_CHUNK (O(L*chunk) scores
    memory)."""
    B, L, H, dh = q.shape
    pos = torch.arange(L, dtype=torch.int64, device=q.device)
    if L <= Q_CHUNK:
        bias = _mask_bias(pos, pos, window)[None]
        return _sdpa(q, k, v, bias.expand(B, L, L), cap, scale)
    if L % Q_CHUNK:
        raise ValueError(f"sequence length {L} is not a multiple of "
                         f"{Q_CHUNK}")
    ctxs = []
    for c0 in range(0, L, Q_CHUNK):
        bias = _mask_bias(pos[c0:c0 + Q_CHUNK], pos, window)[None]
        ctxs.append(_sdpa(q[:, c0:c0 + Q_CHUNK], k, v,
                          bias.expand(B, Q_CHUNK, L), cap, scale))
    return torch.cat(ctxs, dim=1)


def init_attn_cache(cfg, batch, cache_len, dtype, window=None, *, device):
    Sc = min(cache_len, window) if window else cache_len
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, Sc, kv, dh), dtype=dtype, device=device),
            "v": torch.zeros((batch, Sc, kv, dh), dtype=dtype, device=device)}


# ======================================================================= MLP
# python-int seed of the structural sparse pattern for one init_mlp call —
# the same derivation as the JAX package's, so both draw equal patterns
MLP_SEED_BASE = 7919


def mlp_seed(seed_hint: int) -> int:
    """Pattern seed of ``init_mlp(..., seed_hint=...)``'s gate weight (up
    uses ``+1``, down ``+2``)."""
    return MLP_SEED_BASE * (seed_hint + 1)


class MLP(nn.Module):
    """Gated MLP: block-sparse ``gate``/``up``/``down`` (``SparseLinear``,
    partitioned when ``cfg.ffn_sparsity.shards`` is set) when
    ``cfg.ffn_sparsity`` is set, else dense ``w_gate``/``w_up``/
    ``w_down``."""

    def __init__(self, cfg, *, dtype, device, generator=None, d_ff=None,
                 seed_hint: int = 0):
        super().__init__()
        self.cfg, self.seed_hint = cfg, seed_hint
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.d_ff = f
        spec = cfg.ffn_sparsity
        if spec is not None:
            # sparse patterns are structural (numpy), seeded by a python int
            seed = mlp_seed(seed_hint)
            for name, s, i, o in (("gate", seed, d, f), ("up", seed + 1, d, f),
                                  ("down", seed + 2, f, d)):
                params, meta = init_sparse_linear(s, i, o, spec, dtype,
                                                  device=device)
                setattr(self, name, SparseLinear(params, meta, spec))
        else:
            self.w_gate = _weight((d, f), d ** -0.5, dtype, device, generator)
            self.w_up = _weight((d, f), d ** -0.5, dtype, device, generator)
            self.w_down = _weight((f, d), f ** -0.5, dtype, device, generator)

    def forward(self, x):
        return mlp(self.cfg, self, x, d_ff=self.d_ff,
                   seed_hints=(self.seed_hint,))


def init_mlp(cfg, generator, dtype, *, device, d_ff=None,
             seed_hint: int = 0) -> MLP:
    return MLP(cfg, dtype=dtype, device=device, generator=generator,
               d_ff=d_ff, seed_hint=seed_hint)


@functools.lru_cache(maxsize=None)
def mlp_sparse_metas(spec, d: int, f: int, seed_hints: tuple,
                     device="cuda"):
    """True structure metas of a sparse MLP whose layers were built with
    ``seed_hints``, merged (``merge_sparse_metas``; ``ShardedMeta``s shard
    by shard).  Returns ``(meta_in, meta_out)``: gate and up share
    ``d -> f``, down is ``f -> d``.  ``device`` keys ``shards="auto"``."""
    metas_in, metas_out = [], []
    for hint in seed_hints:
        seed = mlp_seed(hint)
        for s, i, o, out in ((seed, d, f, metas_in),           # gate
                             (seed + 1, d, f, metas_in),       # up
                             (seed + 2, f, d, metas_out)):     # down
            out.append(sparse_linear_meta(s, i, o, spec, device=device))
    return merge_sparse_metas(metas_in), merge_sparse_metas(metas_out)


def mlp(cfg, p, x, d_ff=None, seed_hints=(0,)):
    """Gated MLP (dense, or block-sparse when ``cfg.ffn_sparsity`` is set
    AND ``p`` holds sparse layers).  Pass the ``seed_hints`` the layer was
    built with; the port runs one layer at a time, so a layer passes its
    own."""
    act = F.silu if cfg.mlp_act == "silu" else \
        functools.partial(F.gelu, approximate="tanh")
    if cfg.ffn_sparsity is not None and isinstance(
            getattr(p, "gate", None), SparseLinear):
        d, f = cfg.d_model, d_ff or cfg.d_ff
        meta_in, meta_out = mlp_sparse_metas(cfg.ffn_sparsity, d, f,
                                             tuple(seed_hints), x.device)
        g = apply_sparse_linear(p.gate.params(), meta_in, x, cfg.ffn_sparsity)
        u = apply_sparse_linear(p.up.params(), meta_in, x, cfg.ffn_sparsity)
        return apply_sparse_linear(p.down.params(), meta_out, act(g) * u,
                                   cfg.ffn_sparsity)
    return _dense(act(_dense(x, p.w_gate)) * _dense(x, p.w_up), p.w_down)
