"""Block-sparse attention: the SDDMM/SpMM pair as a sequence-mixing layer.

The paper's ops power two workloads: sparse *weights* (the FFN path) and
sparse *interactions*: attention whose score matrix is only evaluated on a
static block mask.  This module builds the second one from the public ops:

    scores = ops.sddmm(mask, Q, K)        # Q K^T sampled at stored blocks
    probs  = block_softmax(scores)        # per query row, stored keys only
    ctx    = ops.spmm(mask<-probs, V)     # probs @ V over the same structure

or, with ``backend="fused"`` (or ``"auto"`` picking it), as ONE launch of
kernel B5 (``kernels.bcsr_attn.bcsr_attn_fused``), which computes the
score blocks in two passes (the row max, then the softmax sums and the
context together) and writes no score or probability block to device
memory.  Its backward recomputes the composed path and
differentiates it, one head at a time: SpMM and SDDMM are mutual duals, so
d(ctx)/d{Q,K,V} runs on their kernels.

Masks are static (a pure function of ``(mask_spec, seq_len, block)``): the
host pipeline (``attention_mask_bcsr``, ``_meta``, ``_arrays``,
``decode_page_table``, ``_fused_inputs``) is memoized and equal to the JAX
package's, and the device tensors of a mask are built once per ``(spec,
seq_len, block, device)`` by ``ops.prepare`` (``mask_tensors``), so a call
moves no mask to the card.

``AttnSparsitySpec(shards=S)`` runs the context product over the row
partition of the mask (``launch.dist_spmm``, ``_mask_sharded``), always on
the composed path.  Left out, each to its ROADMAP item:
``attention_mask_report`` (its caller is the dry-run, A10) and
``merged_attention_meta`` (no caller yet).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bcsr as bcsr_lib
# the spec/builder leaf lives in core (configs imports it too); this module
# is the user-facing namespace, so re-export the whole surface:
from repro_torch.core.attention_mask import (NEG_INF, AttnMaskSpec,  # noqa: F401
                                             AttnSparsitySpec, banded,
                                             blockwise_causal, local_global,
                                             mask_allowed)
from repro_torch.kernels import bcsr_attn, ops


def decode_mask_bias(spec: AttnMaskSpec, q_pos: torch.Tensor,
                     k_pos: torch.Tensor) -> torch.Tensor:
    """Additive decode-step bias ``[..., Lq, Sk]`` applying the SAME mask
    the block-sparse train/prefill path realizes."""
    return torch.where(mask_allowed(spec, q_pos, k_pos), 0.0, NEG_INF)


@functools.lru_cache(maxsize=None)
def decode_page_table(spec: AttnMaskSpec, seq_len: int,
                      block: Tuple[int, int]):
    """Serving page table of the mask: the mask BCSR reshaped to a
    ``[n_block_rows, max_bpr]`` slot grid.  Row ``i`` lists, in ascending
    key order, the KV pages (block-columns of width ``block[1]``) that
    queries of block-row ``i`` can touch; ``live`` marks real slots.
    Host numpy constants, memoized.  Returns ``(pages, live, meta)``.

    >>> from repro_torch.models import attention as A
    >>> pages, live, meta = A.decode_page_table(A.banded(32), 64, (16, 16))
    >>> pages.shape == live.shape == (4, meta.max_bpr)
    True
    >>> pages[3][live[3]].tolist()      # block-row 3 touches pages 1..3
    [1, 2, 3]
    """
    a = attention_mask_bcsr(spec, seq_len, block)
    meta = attention_mask_meta(spec, seq_len, block)
    nbr = meta.n_block_rows
    slots = max(meta.max_bpr, 1)
    pages = np.zeros((nbr, slots), np.int32)
    live = np.zeros((nbr, slots), bool)
    counts = np.bincount(a.row_ids, minlength=nbr)
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(a.row_ids.shape[0]) - rowptr[a.row_ids]
    pages[a.row_ids, slot] = a.col_ids          # ascending within each row
    live[a.row_ids, slot] = True
    pages.setflags(write=False)
    live.setflags(write=False)
    return pages, live, meta


def decode_page_tensors(spec: AttnMaskSpec, seq_len: int,
                        block: Tuple[int, int], device):
    """``decode_page_table``'s ``(pages, live)`` as tensors on ``device``
    (``pages`` int64, the index type of a gather), built once and cached
    per ``(spec, seq_len, block, device)`` as ``mask_tensors`` caches the
    mask, so a paged decode call copies nothing from the host."""
    return _decode_page_tensors(spec, seq_len, tuple(block),
                                _cache_device(device))


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _decode_page_tensors(spec: AttnMaskSpec, seq_len: int,
                         block: Tuple[int, int], device: torch.device):
    pages, live, _ = decode_page_table(spec, seq_len, block)
    return (torch.from_numpy(pages.astype(np.int64)).to(device),
            torch.from_numpy(live.copy()).to(device))


# ======================================================== mask BCSR pipeline
@functools.lru_cache(maxsize=None)
def attention_mask_bcsr(spec: AttnMaskSpec, seq_len: int,
                        block: Tuple[int, int]) -> bcsr_lib.BCSR:
    """Host BCSR of the element mask (vals are 0/1 f32; blocks with any
    allowed element are stored), memoized.  Built one block-row strip at a
    time (peak O(h * L) host memory), equal to ``from_dense`` of the full
    dense mask (entries row-major by (block-row, block-col))."""
    h, w = block
    nbr = -(-seq_len // h)
    nbc = -(-seq_len // w)
    k_pos = np.arange(nbc * w)
    k_valid = k_pos < seq_len
    rows, cols, vals = [], [], []
    for i in range(nbr):
        q_pos = np.arange(i * h, (i + 1) * h)
        strip = mask_allowed(spec, q_pos, k_pos)
        strip &= k_valid[None, :] & (q_pos < seq_len)[:, None]
        blocks = strip.reshape(h, nbc, w).transpose(1, 0, 2)  # [nbc, h, w]
        nz = np.flatnonzero(blocks.any(axis=(1, 2)))
        rows.append(np.full(nz.size, i, np.int32))
        cols.append(nz.astype(np.int32))
        vals.append(blocks[nz].astype(np.float32))
    row_ids = np.concatenate(rows)
    col_ids = np.concatenate(cols)
    vals = np.concatenate(vals) if row_ids.size else \
        np.zeros((0, h, w), np.float32)
    return bcsr_lib.BCSR(vals, col_ids, row_ids,
                         bcsr_lib.rowptr_from_rows(row_ids, nbr),
                         (seq_len, seq_len), (h, w))


@functools.lru_cache(maxsize=None)
def attention_mask_meta(spec: AttnMaskSpec, seq_len: int,
                        block: Tuple[int, int]) -> ops.SparseMeta:
    """True structure meta of the mask (``prepare_sparse_meta`` of the
    mask BCSR), memoized: what ``backend="auto"`` fingerprints."""
    return ops.prepare_sparse_meta(attention_mask_bcsr(spec, seq_len, block))


@functools.lru_cache(maxsize=None)
def attention_mask_arrays(spec: AttnMaskSpec, seq_len: int,
                          block: Tuple[int, int]
                          ) -> Tuple[ops.SparseArrays, ops.SparseMeta]:
    """Host (numpy) arrays + meta of the mask structure: the JAX package's
    fields, then the port's (``ops.PORT_FIELDS``, the schedules).  Index
    structure and 0/1 element weights: no parameters, no gradient."""
    host, meta = ops._prepare_sparse_host(
        attention_mask_bcsr(spec, seq_len, block), reorder="identity",
        reorder_granularity="element", tau=0.7, max_candidates=None,
        n_shards=1)
    assert meta == attention_mask_meta(spec, seq_len, block)
    arrays = ops.SparseArrays(
        vals=host["vals"].astype(np.float32),
        **{f: np.asarray(host[f]).astype(np.int32)
           for f in ("row_ids", "col_ids", "t_perm", "t_row_ids",
                     "t_col_ids", "row_perm", "inv_perm") + ops.PORT_FIELDS},
        real_mask=host["real_mask"])
    return arrays, meta


@functools.lru_cache(maxsize=None)
def _fused_inputs(spec: AttnMaskSpec, seq_len: int, block: Tuple[int, int]):
    """Host constants of the fused kernel: the 0/1 element-mask blocks
    (stored AND allowed AND not padding) and the static (block-row x slot)
    schedule, padding slots -> the sentinel index ``nnzb`` (the SDDMM
    schedule ``ops.prepare`` builds).  Returns ``(emask, flat_idx,
    flat_col, meta)``, as the JAX package's ``_fused_inputs``."""
    arrays, meta = attention_mask_arrays(spec, seq_len, block)
    emask = ((arrays.vals > 0.5) &
             arrays.real_mask[:, None, None]).astype(np.float32)
    return emask, arrays.sddmm_flat_idx, arrays.flat_col, meta


class MaskTensors(NamedTuple):
    """A mask's tensors on one device.  ``arrays`` is ``ops.prepare``'s
    ``SparseArrays`` with ``vals`` holding ``emask`` (the composed path
    replaces them with probabilities); ``arrays.sddmm_flat_idx`` and
    ``arrays.flat_col`` are the schedule kernel B5 reads, and ``ebits`` its
    mask."""
    arrays: ops.SparseArrays
    meta: ops.SparseMeta
    emask: torch.Tensor        # [nnzb, h, w] f32 0/1
    elem_mask: torch.Tensor    # [nnzb, h, w] bool, emask != 0
    ebits: torch.Tensor        # [nnzb + 1, h, ceil(w/32)] int32: packed emask


def mask_tensors(spec: AttnMaskSpec, seq_len: int, block: Tuple[int, int],
                 device) -> MaskTensors:
    """The mask's tensors on ``device``, built once by ``ops.prepare`` and
    cached per ``(spec, seq_len, block, device)``: an eager call would
    otherwise upload the f32 element mask again every time (about 104 MB a
    layer at 8,192 tokens in 128x128 blocks) and pack its bits for B5
    (``bcsr_attn.pack_emask``, 3.2 MB).  ``"cuda"`` names the current card,
    so it shares the entry of ``"cuda:<index>"``."""
    return _mask_tensors(spec, seq_len, tuple(block), _cache_device(device))


def _cache_device(device) -> torch.device:
    """``device`` as a per-device cache key: ``"cuda"`` names the current
    card, so it keys the same entry as ``"cuda:<index>"``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


# the cached tensors are built outside inference mode (``inference_mode(
# False)``), so a cache entry first made while serving can still be saved
# for a backward later in the process
@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _mask_tensors(spec: AttnMaskSpec, seq_len: int, block: Tuple[int, int],
                  device: torch.device) -> MaskTensors:
    arrays, meta = ops.prepare(attention_mask_bcsr(spec, seq_len, block),
                               torch.float32, device=device)
    # valid = stored-and-allowed AND not a padding entry, in place of vals
    emask = ((arrays.vals > 0.5) &
             arrays.real_mask[:, None, None]).to(torch.float32)
    return MaskTensors(arrays._replace(vals=emask), meta, emask, emask != 0,
                       bcsr_attn.pack_emask(emask))


# ============================================================= sparse layer
def block_softmax(scores: torch.Tensor, elem_mask: torch.Tensor,
                  row_ids: torch.Tensor, n_block_rows: int,
                  cap: Optional[float] = None, *,
                  flat_idx: torch.Tensor) -> torch.Tensor:
    """Masked softmax over a BCSR score matrix, per GLOBAL query row.

    scores     [nnzb, h, w] f32 logits (already scaled)
    elem_mask  [nnzb, h, w] bool: valid (stored AND allowed) elements
    row_ids    [nnzb] block-row of each block, sorted
    flat_idx   [nbr * max_bpr] the entry schedule (padding -> nnzb), as
               ``ops.prepare`` builds it (``sddmm_flat_idx``)
    returns    [nnzb, h, w] probabilities; masked elements are exactly 0,
               each valid query row sums to 1 across its stored blocks.

    The JAX package reduces over block-rows with ``segment_max`` and
    ``segment_sum``.  Here both reductions go through the schedule: the
    per-block row maxima and sums are gathered into ``[nbr, max_bpr, h]``
    (padding slots -inf and 0) and reduced over the slot axis, a fixed
    order on every device, where ``index_add_`` on the card would sum with
    atomics in an order that changes from run to run.
    """
    if cap is not None:
        scores = cap * torch.tanh(scores / cap)
    logits = torch.where(elem_mask, scores, NEG_INF)
    slots = flat_idx.long()
    rows = row_ids.long()
    h = scores.shape[1]
    blk_max = logits.amax(dim=2)                                # [nnzb, h]
    pad = blk_max.new_full((1, h), float("-inf"))
    row_max = torch.cat([blk_max, pad])[slots].reshape(
        n_block_rows, -1, h).amax(dim=1).clamp_min(-1e30)        # [nbr, h]
    z = torch.exp(logits - row_max[rows][:, :, None])
    z = torch.where(elem_mask, z, 0.0)
    blk_sum = z.sum(dim=2)                                       # [nnzb, h]
    denom = torch.cat([blk_sum, blk_sum.new_zeros((1, h))])[slots].reshape(
        n_block_rows, -1, h).sum(dim=1).clamp_min(1e-30)         # [nbr, h]
    return z / denom[rows][:, :, None]


def mask_sharded(spec: AttnMaskSpec, seq_len: int, block: Tuple[int, int],
                 n_shards: int, device):
    """Row partition of the mask structure (``launch.dist_spmm``): the
    context SpMM's operand split over block-rows by the LPT balancer, as
    ``(ShardedArrays, ShardedMeta)`` on ``device``, built once per
    ``(spec, seq_len, block, n_shards, device)`` as ``mask_tensors``
    caches the mask.  The flat probabilities the SDDMM gives drop into its
    ``vals`` untouched: both sides come from the same padded host BCSR,
    so the global entry order is shared."""
    return _mask_sharded(spec, seq_len, tuple(block), int(n_shards),
                         _cache_device(device))


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _mask_sharded(spec: AttnMaskSpec, seq_len: int, block: Tuple[int, int],
                  n_shards: int, device: torch.device):
    from repro_torch.launch import dist_spmm  # local: layering
    host, smeta = dist_spmm._prepare_sharded_host(
        attention_mask_bcsr(spec, seq_len, block), n_shards)
    meta = attention_mask_meta(spec, seq_len, block)
    if smeta.nnzb != meta.nnzb:   # same padded entry list by construction
        raise AssertionError(
            f"sharded/unsharded mask entry counts diverged: "
            f"{smeta.nnzb} vs {meta.nnzb}")
    return (dist_spmm.sharded_tensors(host, smeta, torch.float32, device),
            smeta)


def _context_spmm(probs: torch.Tensor, arrays: ops.SparseArrays,
                  meta: ops.SparseMeta, v: torch.Tensor,
                  spec: AttnSparsitySpec) -> torch.Tensor:
    """ctx = probs @ V over the mask structure: unsharded, or through the
    ``dist_spmm`` row partition when ``spec.shards > 0`` (over the ambient
    spmm mesh when its ``spmm`` axis has ``spec.shards`` ranks, else
    in-process, as the JAX package falls back)."""
    if spec.shards > 0:
        from repro_torch.launch import dist_spmm  # local: layering
        sharr, smeta = mask_sharded(spec.mask, meta.shape[0], meta.block,
                                    spec.shards, probs.device)
        mesh = dist_spmm.current_spmm_mesh()
        if mesh is not None:
            from repro_torch.launch.mesh import axis_sizes
            if axis_sizes(mesh).get(dist_spmm.AXIS_ROW) != spec.shards:
                mesh = None     # incompatible ambient mesh: in-process
        return dist_spmm.spmm_sharded(
            sharr._replace(vals=probs), smeta, v, backend=spec.backend,
            mesh=mesh)
    return ops.spmm(arrays._replace(vals=probs), meta, v,
                    backend=spec.backend)


def _composed_spec(spec: AttnSparsitySpec) -> AttnSparsitySpec:
    """The spec the composed three-dispatch path runs under:
    ``backend="fused"`` is an attention-level choice the SDDMM/SpMM ops do
    not know; it becomes ``"auto"`` for them."""
    if spec.backend == "fused":
        return dataclasses.replace(spec, backend="auto")
    return spec


def _composed_heads(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                    spec: AttnSparsitySpec, scale: float,
                    cap: Optional[float]) -> torch.Tensor:
    """SDDMM -> block softmax -> SpMM over folded ``[G, L, d]`` heads: the
    three-dispatch path (and the backward route of the fused forward).  The
    ops take one instance at a time, so the G instances run in a loop
    (the JAX package ``vmap``s them): 2 kernel launches per instance."""
    spec = _composed_spec(spec)
    mt = mask_tensors(spec.mask, qf.shape[1], tuple(spec.block), qf.device)
    arrays, meta = mt.arrays, mt.meta

    def one_head(qi, ki, vi):
        scores = ops.sddmm(arrays, meta, qi, ki, backend=spec.backend,
                           out_dtype=torch.float32)
        probs = block_softmax(scores * scale, mt.elem_mask, arrays.row_ids,
                              meta.n_block_rows, cap=cap,
                              flat_idx=arrays.sddmm_flat_idx)
        return _context_spmm(probs, arrays, meta, vi, spec)

    return torch.stack([one_head(qf[g], kf[g], vf[g])
                        for g in range(qf.shape[0])])


def _fused_heads(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                 spec: AttnSparsitySpec, scale: float,
                 cap: Optional[float]) -> torch.Tensor:
    mt = mask_tensors(spec.mask, qf.shape[1], tuple(spec.block), qf.device)
    meta = mt.meta
    return bcsr_attn.bcsr_attn_fused(
        qf, kf, vf, mt.emask, mt.arrays.sddmm_flat_idx, mt.arrays.flat_col,
        n_block_rows=meta.n_block_rows, n_block_cols=meta.n_block_cols,
        block=meta.block, scale=scale, cap=cap, out_dtype=torch.float32,
        ebits=mt.ebits)


class _AttnFused(torch.autograd.Function):
    """Fused forward (kernel B5), composed backward.  The backward
    recomputes the composed path and differentiates it one instance at a
    time: one head's scores, probabilities and their gradients at 8,192
    tokens come to about 0.5 GB, all 16 at once to 8 GB.  The instances
    are independent, so this equals the gradient of the whole batch."""

    @staticmethod
    def forward(ctx, spec, scale, cap, qf, kf, vf):
        ctx.spec, ctx.scale, ctx.cap = spec, scale, cap
        ctx.save_for_backward(qf, kf, vf)
        return _fused_heads(qf, kf, vf, spec, scale, cap)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf = ctx.saved_tensors
        grads = [torch.empty_like(t) for t in (qf, kf, vf)]
        for i in range(qf.shape[0]):
            with torch.enable_grad():
                qkv = [t[i:i + 1].detach().requires_grad_()
                       for t in (qf, kf, vf)]
                out = _composed_heads(*qkv, ctx.spec, ctx.scale, ctx.cap)
                parts = torch.autograd.grad(out, qkv, g[i:i + 1])
            for dst, part in zip(grads, parts):
                dst[i:i + 1] = part
        return (None, None, None, *grads)


_attn_fused = _AttnFused.apply


def resolve_attn_impl(spec: AttnSparsitySpec, seq_len: int, head_dim: int,
                      device="cuda") -> str:
    """``"fused"`` | ``"composed"``: the attention-level dispatch.

    Explicit kernel backends (``nnz_stream``/``row_loop``/``xla``/...) and
    sharded score paths stay composed; ``backend="fused"`` forces kernel
    B5; ``backend="auto"`` asks the tuner's ``attn`` family for this
    structure on ``device`` (keys disjoint from the sddmm/spmm ones)."""
    if spec.shards > 0 or spec.backend not in ("auto", "fused"):
        return "composed"
    meta = attention_mask_meta(spec.mask, seq_len, tuple(spec.block))
    if meta.max_bpr <= 0:
        return "composed"   # no static schedule bound -> no fused walk
    if spec.backend == "fused":
        return "fused"
    from repro_torch.kernels import autotune  # local import: layering
    choice = autotune.get_autotuner().pick(meta, head_dim, op="attn",
                                           device=device)
    return "fused" if choice.variant == "attn_fused" else "composed"


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           spec: AttnSparsitySpec, *,
                           scale: Optional[float] = None,
                           cap: Optional[float] = None) -> torch.Tensor:
    """Attention with scores evaluated only on the stored mask blocks.

    q, k, v  [B, L, H, d]  (GQA callers repeat KV heads first)
    returns  [B, L, H, d] in f32 (callers cast), matching the dense-masked
             reference on the mask support.

    Each (batch, head) instance is SDDMM -> block softmax -> SpMM, either
    as three dispatches or, when ``resolve_attn_impl`` picks the fused path,
    as one launch of kernel B5, whose backward differentiates the composed
    path.  ``shards > 0`` runs the context product over the mask's row
    partition (composed).

    >>> import numpy as np, torch
    >>> from repro_torch.models import attention as A
    >>> rng = np.random.default_rng(0)
    >>> q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 2, 8)))
    ...            .float() for _ in range(3))
    >>> spec = A.AttnSparsitySpec(mask=A.banded(32), block=(8, 8),
    ...                           backend="xla")
    >>> out = A.block_sparse_attention(q, k, v, spec)
    >>> out.shape
    torch.Size([2, 64, 2, 8])
    >>> bool(torch.isfinite(out).all())
    True
    """
    B, L, H, d = q.shape
    scale = float(d ** -0.5 if scale is None else scale)
    cap = None if cap is None else float(cap)
    qf, kf, vf = (t.transpose(1, 2).reshape(B * H, L, d).float()
                  for t in (q, k, v))
    if resolve_attn_impl(spec, L, d, device=q.device) == "fused":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (qf, kf, vf)):
            ctx = _attn_fused(spec, scale, cap, qf, kf, vf)
        else:
            ctx = _fused_heads(qf, kf, vf, spec, scale, cap)
    else:
        ctx = _composed_heads(qf, kf, vf, spec, scale, cap)
    return ctx.reshape(B, H, L, d).transpose(1, 2)
