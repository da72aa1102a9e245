"""Transformer layer components: norms, RoPE, GQA attention (sliding window,
logit softcap, QKV bias, or block-sparse scores on a static BCSR mask:
``cfg.attn_sparsity``), MLA (DeepSeek) and the gated MLP, dense or
block-sparse (the paper's technique as a drop-in FFN).

Conventions (those of the JAX package):
  * activations are [B, L, D]; decode caches are ring buffers written at
    ``pos % cache_len``;
  * attention math accumulates in float32;
  * the functions take the layer's module (``Attention``, ``MLA``, ``MLP``)
    as ``p``
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
from repro_torch.launch.constrain import (BATCH, MODEL, constrain, gather,
                                          local_seq, model_split, scatter)
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


# ================================================================ remat tags
@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()        # a custom op's output may not alias its input


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))
# the op ``checkpoint_name`` records: what ``remat="names"``'s policy saves
CHECKPOINT_NAME_OP = torch.ops.repro_torch.checkpoint_name.default


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """The twin of JAX's ``checkpoint_name``: ``x``, tagged ``name`` for
    ``remat="names"`` (``transformer.SAVED_NAMES``).  With autograd on the
    tag is a copy of ``x`` through the ``repro_torch::checkpoint_name`` op,
    equal bit for bit; outside autograd (serving) ``x`` itself."""
    if not torch.is_grad_enabled():
        return x
    return torch.ops.repro_torch.checkpoint_name(x, name)


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
    -> [B,Lq,H,dv] (dv may differ from dh: MLA's 128 against 192); scores
    and softmax in float32."""
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


def pages_decode(sparse, cache_len: int, max_bpr) -> bool:
    """The paged-decode decision for one attention layer, as the JAX
    package makes it.  ``AttnSparsitySpec.paged_decode``: "off" never
    pages; "force" pages wherever pages tile the KV ring exactly and the
    mask has a live block; "auto" also requires a strict page saving
    (``max_bpr < n_pages``).  ``max_bpr()`` gives the most live blocks of
    a block-row of the mask at ``cache_len``; it is called only where the
    pages tile the ring, so a layer that cannot page builds no table."""
    if sparse is None or sparse.paged_decode == "off":
        return False
    w = sparse.block[1]
    if cache_len % w != 0:          # pages must tile the KV ring exactly
        return False
    most = max_bpr()
    if most <= 0:
        return False
    # "auto" without a page saving keeps the dense bias
    return sparse.paged_decode == "force" or most < cache_len // w


def _decode_pages(cfg, window, cache_len):
    """Static paged-decode resolution for one attention layer: the mask
    page table ``(pages, live)`` where ``pages_decode`` pages the KV, else
    None (dense-bias decode).  Where this returns a table, ``attention``
    decodes through ``_paged_decode``."""
    sparse = getattr(cfg, "attn_sparsity", None)
    from repro_torch.models import attention as A

    def table():
        return A.decode_page_table(_sparse_mask(cfg, window), cache_len,
                                   tuple(sparse.block))
    if not pages_decode(sparse, cache_len, lambda: table()[2].max_bpr):
        return None
    pages, live, _ = table()
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
    ``paged_decode`` resolves a page table, else as a positional bias.

    Under a split over ``model`` (training: ``launch.constrain.
    model_split``) ``x`` holds this rank's positions and ``p`` its shards:
    the sequence is gathered, q/k/v computed for the rank's heads (k/v
    whole where the axis does not divide the kv heads: projected on the
    rank's positions and gathered) with rope at global positions, and
    ``wo``'s row-parallel partial sums reduce-scattered back to the
    rank's positions."""
    split = model_split() if cache is None else None
    mine = x                              # this rank's positions
    if split is not None:
        x = gather(x, 1)                  # the whole sequence
    B, L, D = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    theta = rope_theta or cfg.rope_theta
    heads = p.wq.shape[-1] // dh          # this rank's: h / model if split
    q = _dense(x, p.wq, p.bq).reshape(B, L, heads, dh)
    if heads < h and p.wk.shape[-1] == kv * dh:
        # q split, k/v whole (the model axis does not divide the kv heads):
        # k/v of this rank's positions, gathered (the ranks' gradients meet
        # before the projection's), at the kv head of each of its q heads
        first = split.index * heads
        idx = torch.arange(first, first + heads, device=x.device) // (h // kv)
        k, v = (gather(_dense(mine, w, b), 1).reshape(B, L, kv, dh)
                .index_select(2, idx) for w, b in ((p.wk, p.bk),
                                                    (p.wv, p.bv)))
    else:
        k = _dense(x, p.wk, p.bk).reshape(B, L, -1, dh)
        v = _dense(x, p.wv, p.bv).reshape(B, L, -1, dh)

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

    y = _dense(ctx.reshape(B, L, heads * dh).to(x.dtype), p.wo)
    if split is not None:
        # row-parallel wo: the heads' partial sums, reduce-scattered back to
        # the sequence split (replicated heads: this rank's positions)
        y = scatter(y, 1) if heads < h else local_seq(y, 1)
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


# ======================================================================= MLA
class MLA(nn.Module):
    """Multi-head Latent Attention's weights (DeepSeek-V2): q through
    ``wq``, or ``wq_a`` -> ``q_norm`` -> ``wq_b`` with ``cfg.q_lora_rank``;
    the latent ``c_kv`` and a shared rope key through ``wkv_a``; per-head
    K and V from the latent through ``wkv_b``."""

    def __init__(self, cfg, *, dtype, device, generator=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        nope, rope, vd, r = (cfg.nope_head_dim, cfg.rope_head_dim,
                             cfg.v_head_dim, cfg.kv_lora_rank)
        s = d ** -0.5
        q_dim = h * (nope + rope)
        if cfg.q_lora_rank:
            qr = cfg.q_lora_rank
            self.wq_a = _weight((d, qr), s, dtype, device, generator)
            self.q_norm = nn.Parameter(torch.zeros(qr, device=device))
            self.wq_b = _weight((qr, q_dim), qr ** -0.5, dtype, device,
                                generator)
        else:
            self.wq = _weight((d, q_dim), s, dtype, device, generator)
        self.wkv_a = _weight((d, r + rope), s, dtype, device, generator)
        self.kv_norm = nn.Parameter(torch.zeros(r, device=device))
        self.wkv_b = _weight((r, h * (nope + vd)), r ** -0.5, dtype, device,
                             generator)
        self.wo = _weight((h * vd, d), (h * vd) ** -0.5, dtype, device,
                          generator)


def init_mla(cfg, generator, dtype, *, device) -> MLA:
    return MLA(cfg, dtype=dtype, device=device, generator=generator)


def mla_attention(cfg, p, x, *, cache=None, pos=None, slot_mask=None):
    """Multi-head Latent Attention; returns (y, cache).  The cache holds
    the compressed latent (``ckv`` [B, S, r]) and the shared rope key
    (``krope`` [B, S, rope]) only.  Modes as ``attention``'s:

      train/prefill: per-head K [.., nope + rope] and V [.., v_head_dim]
        built from the latent, through ``_causal_attention``; a prefill
        writes the last ``S`` positions' latents at slots 0.. of the ring
        (a ring read back at ``pos % S`` only while ``L <= S``);
      decode (L == 1, ``pos`` an int): the absorbed form in float32
        against the ring, written in place at ``pos % S`` (only the rows
        where ``slot_mask`` [B] is True, when given).

    Under a split over ``model`` (training: ``launch.constrain.
    model_split``) ``x`` holds this rank's positions and ``p`` its shards.
    The latent and the rope key (``wkv_a``, ``kv_norm``; rope at the
    positions' global indices) are computed on the rank's positions and
    gathered: the 576-wide latent crosses, not the per-head K/V (the JAX
    package's choice), and each rank's gradient reaches its positions
    once.  q is computed on the gathered sequence (with ``q_lora_rank``:
    the rank's normed ``wq_a`` latent, gathered) for the rank's heads, K/V
    from its columns of ``wkv_b``; ``wo`` is row-parallel and its partial
    sums are reduce-scattered back to the rank's positions.  Where the
    axis does not divide the heads the weights are whole: every rank runs
    every head on the whole sequence and keeps its positions."""
    split = model_split() if cache is None else None
    B, Lm, D = x.shape                    # Lm: this rank's positions
    h = cfg.n_heads
    nope, rope, vd, r = (cfg.nope_head_dim, cfg.rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
    heads = p.wkv_b.shape[-1] // (nope + vd)   # this rank's: h / model
    L = Lm * split.size if split is not None else Lm
    positions = torch.arange(L, dtype=torch.int64, device=x.device)
    if cache is not None and pos is not None:
        positions = positions + pos
    positions = positions[None, :].expand(B, L)
    first = split.index * Lm if split is not None else 0

    kv_a = _dense(x, p.wkv_a)                           # [B, Lm, r + rope]
    c_kv = rms_norm(kv_a[..., :r], p.kv_norm)
    k_rope = apply_rope(kv_a[..., r:].reshape(B, Lm, 1, rope),
                        positions[:, first:first + Lm], cfg.rope_theta)
    if cfg.q_lora_rank:
        q_in, w_q = rms_norm(_dense(x, p.wq_a), p.q_norm), p.wq_b
    else:
        q_in, w_q = x, p.wq
    if split is not None:
        latent = gather(torch.cat([c_kv, k_rope[:, :, 0]], dim=-1), 1)
        c_kv, k_rope = latent[..., :r], latent[..., None, r:]
        q_in = gather(q_in, 1)
    q = _dense(q_in, w_q).reshape(B, L, heads, nope + rope)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)

    if cache is not None and L == 1:
        # ---- absorbed decode: score against the latent cache directly
        scale = (nope + rope) ** -0.5
        w_kv_b = p.wkv_b.reshape(r, h, nope + vd)
        w_uk, w_uv = w_kv_b[..., :nope], w_kv_b[..., nope:]
        ckv_c, krope_c = cache["ckv"], cache["krope"]
        Sc = ckv_c.shape[1]
        slot = pos % Sc
        c_new = c_kv[:, 0].to(ckv_c.dtype)
        r_new = k_rope[:, 0, 0].to(krope_c.dtype)
        if slot_mask is not None:
            keep = slot_mask[:, None]
            c_new = torch.where(keep, c_new, ckv_c[:, slot])
            r_new = torch.where(keep, r_new, krope_c[:, slot])
        ckv_c[:, slot] = c_new
        krope_c[:, slot] = r_new
        q_lat = torch.einsum("blhn,rhn->blhr", q_nope.float(),
                             w_uk.float())                 # [B,1,h,r]
        s_lat = torch.einsum("blhr,bsr->bhls", q_lat, ckv_c.float())
        s_rope = torch.einsum("blhe,bse->bhls", q_rope.float(),
                              krope_c.float())
        scores = (s_lat + s_rope) * scale
        j = torch.arange(Sc, dtype=torch.int64, device=x.device)
        k_pos = pos - ((pos - j) % Sc)       # ring-buffer slot positions
        q_pos = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        bias = _mask_bias(q_pos, k_pos, None)             # [1, Sc]
        probs = torch.softmax(scores + bias[None, None], dim=-1)
        ctx_lat = torch.einsum("bhls,bsr->blhr", probs, ckv_c.float())
        ctx = torch.einsum("blhr,rhv->blhv", ctx_lat, w_uv.float())
    else:
        # ---- train/prefill: materialize per-head K, V
        ctx = _mla_heads(cfg, p, q_nope, q_rope, c_kv, k_rope)
        if cache is not None:               # prefill: write latent cache
            ckv_c, krope_c = cache["ckv"], cache["krope"]
            Sc = ckv_c.shape[1]
            n = min(L, Sc)
            ckv_c[:, :n] = c_kv[:, -Sc:].to(ckv_c.dtype)
            krope_c[:, :n] = k_rope[:, -Sc:, 0].to(krope_c.dtype)

    y = _dense(ctx.reshape(B, L, heads * vd).to(x.dtype), p.wo)
    if split is not None:
        y = scatter(y, 1) if heads < h else local_seq(y, 1)
    return y, cache


def _mla_heads(cfg, p, q_nope, q_rope, c_kv, k_rope):
    """Causal attention of the heads ``p.wkv_b`` holds (all of them, or
    this rank's under a split over ``model``): their K [.., nope + rope]
    and V [.., v_head_dim] built from the latent ``c_kv`` [B, L, r] and
    the shared rope key ``k_rope`` [B, L, 1, rope], their queries
    ``q_nope``/``q_rope`` [B, L, heads, .]; returns ctx [B, L, heads,
    v_head_dim] (heads over ``model``, where the JAX package constrains
    them)."""
    B, L = c_kv.shape[:2]
    nope, rope, vd, r = (cfg.nope_head_dim, cfg.rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
    heads = p.wkv_b.shape[-1] // (nope + vd)
    w_kv_b = p.wkv_b.reshape(r, heads, nope + vd)
    w_uk, w_uv = w_kv_b[..., :nope], w_kv_b[..., nope:]
    k_nope = torch.einsum("blr,rhn->blhn", c_kv, w_uk.to(c_kv.dtype))
    v = torch.einsum("blr,rhv->blhv", c_kv, w_uv.to(c_kv.dtype))
    k = torch.cat([k_nope, k_rope.expand(B, L, heads, rope)], dim=-1)
    qq = constrain(torch.cat([q_nope, q_rope], dim=-1), BATCH, None, MODEL)
    k = constrain(k, BATCH, None, MODEL)
    v = constrain(v, BATCH, None, MODEL)
    ctx = _causal_attention(qq, k, v, None, None, (nope + rope) ** -0.5)
    return checkpoint_name(ctx, "attn_ctx")


def init_mla_cache(cfg, batch, cache_len, dtype, *, device):
    return {"ckv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, cache_len, cfg.rope_head_dim),
                                 dtype=dtype, device=device)}


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
    own.  Under a split over ``model`` ``x`` holds this rank's positions:
    the block-sparse FFN runs on them against its replicated weights; a
    dense one split by the rules gathers the sequence, runs its hidden
    columns and reduce-scatters ``w_down``'s partial sums."""
    if cfg.ffn_sparsity is not None and isinstance(
            getattr(p, "gate", None), SparseLinear):
        d, f = cfg.d_model, d_ff or cfg.d_ff
        meta_in, meta_out = mlp_sparse_metas(cfg.ffn_sparsity, d, f,
                                             tuple(seed_hints), x.device)
        g = apply_sparse_linear(p.gate.params(), meta_in, x, cfg.ffn_sparsity)
        u = apply_sparse_linear(p.up.params(), meta_in, x, cfg.ffn_sparsity)
        return apply_sparse_linear(p.down.params(), meta_out,
                                   mlp_act(cfg)(g) * u,
                                   cfg.ffn_sparsity)
    if model_split() is not None and p.w_gate.shape[-1] < (d_ff or cfg.d_ff):
        # column-parallel gate/up, row-parallel down on the whole sequence
        return scatter(dense_mlp(cfg, p, gather(x, 1)), 1)
    return dense_mlp(cfg, p, x)


def dense_mlp(cfg, p, x):
    """The dense gated MLP of the hidden columns ``p`` holds: the whole
    output, or under a split over ``model`` the rank's row-parallel
    partial sum."""
    return _dense(mlp_act(cfg)(_dense(x, p.w_gate)) * _dense(x, p.w_up),
                  p.w_down)


def mlp_act(cfg):
    """The gated MLPs' activation: SiLU, or tanh-approximated GELU."""
    return F.silu if cfg.mlp_act == "silu" else \
        functools.partial(F.gelu, approximate="tanh")
