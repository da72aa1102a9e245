"""The SpMM/SDDMM op pair: kernel-ready BCSR operands, backend dispatch and
the two mutually dual gradients.

``prepare`` turns a host ``BCSR`` into the device tensors of a
``SparseArrays`` (optionally row-reordered, entries padded so every
block-row is nonempty, plus the transpose structure the backward reads and
the ``row_loop`` schedules) and a static ``SparseMeta``.  ``spmm`` computes
C = A @ B and ``sddmm`` the blocks of X @ Y^T stored by A's structure, each
through one of:

  * ``nnz_stream`` -- the hand-written CUDA kernels that stream each
    block-row's entries (``bcsr_spmm_nnz_stream``, ``kernels/csrc/
    bcsr_spmm.cu``, for spmm and for dB = A^T dC over the transpose
    structure; ``bcsr_sddmm``, ``kernels/csrc/bcsr_sddmm.cu``, for sddmm
    and so for dvals); ``pallas`` is accepted as an alias, the JAX
    package's name.
  * ``row_loop``   -- SMaT's static schedule: every block-row loops over
    ``max_bpr`` slots (``bcsr_spmm_row_loop`` and ``bcsr_sddmm_row_loop``,
    ``kernels/csrc/bcsr_*_row_loop.cu``); dB stays on the streamed kernel
    over the transpose structure, as in the JAX package.
  * ``xla``        -- the plain PyTorch versions (``kernels/ref.py``), only
    when a caller names them.
  * ``dense``      -- materialize the dense operand (or product) and multiply.
  * ``auto``       -- the autotuner's pick among the two kernel backends
    (``kernels.autotune``): a measured entry for this structure on this
    device, else the analytic model's.  It never resolves to ``xla`` or
    ``dense``.

On a CPU tensor the kernel wrappers run their plain versions.  Both ops are
differentiable: ``spmm``'s backward gives dB through the transpose
structure and dvals through ``sddmm``; ``sddmm``'s gives dX through
``spmm`` and dY through the transpose structure, so higher derivatives
bounce between the two ``torch.autograd.Function``s, as the JAX package's
custom VJPs do.  Without grad (serving runs under
``torch.inference_mode()``) the ops call their forward directly and add no
autograd work.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.core import bcsr as bcsr_lib
from repro_torch.core import permute as permute_lib
from repro_torch.kernels import bcsr_spmm as pk
from repro_torch.kernels import ref


# ---------------------------------------------------------------------- types
class SparseArrays(NamedTuple):
    """Device tensors of a BCSR operand.

    The fields up to ``inv_perm`` are those of the JAX package, equal to
    them element for element.  The rest (``PORT_FIELDS``) are the port's
    own, built once on the host by ``prepare``: the streamed SpMM kernel
    reads each block-row's entry range from ``rowptr`` (of A in the
    forward) and ``t_rowptr`` (of A^T in the backward); the ``row_loop``
    kernels read the static schedule (``flat_idx``/``flat_col``/``row_len``
    for SpMM, ``sddmm_flat_idx``/``flat_col`` for SDDMM), which the JAX
    package builds inside each call instead."""
    vals: torch.Tensor        # [nnzb, h, w]
    row_ids: torch.Tensor     # [nnzb] int32, sorted row-major
    col_ids: torch.Tensor     # [nnzb] int32
    real_mask: torch.Tensor   # [nnzb] bool — False for padding entries
    t_perm: torch.Tensor      # [nnzb_t] int32 into vals (nnzb == sentinel)
    t_row_ids: torch.Tensor   # [nnzb_t] int32 (block-rows of A^T)
    t_col_ids: torch.Tensor   # [nnzb_t] int32
    row_perm: Optional[torch.Tensor] = None   # [M]: A'[i] = A[row_perm[i]]
    inv_perm: Optional[torch.Tensor] = None   # [M]: argsort(row_perm)
    rowptr: Optional[torch.Tensor] = None     # [nbr + 1] int32
    t_rowptr: Optional[torch.Tensor] = None   # [nbc + 1] int32 (of A^T)
    flat_idx: Optional[torch.Tensor] = None   # [nbr * max_bpr] int32, pad 0
    flat_col: Optional[torch.Tensor] = None   # [nbr * max_bpr] int32, pad 0
    row_len: Optional[torch.Tensor] = None    # [nbr] int32
    sddmm_flat_idx: Optional[torch.Tensor] = None  # as flat_idx, pad nnzb


# the fields the JAX package does not have, rebuilt from the others
# (``port_fields``)
PORT_FIELDS = ("rowptr", "t_rowptr", "flat_idx", "flat_col", "row_len",
               "sddmm_flat_idx")


@dataclasses.dataclass(frozen=True)
class SparseMeta:
    """Static (hashable) metadata of a sparse operand."""
    shape: Tuple[int, int]          # logical (M, K)
    block: Tuple[int, int]          # (h, w)
    n_block_rows: int
    n_block_cols: int
    nnzb: int
    nnzb_t: int
    max_bpr: int = 0                # max blocks per block-row (0 = unknown)
    padding_ratio_pct: int = 0      # % of stored values that are zeros
    bpr_cv_pct: int = 0             # blocks-per-row std/mean, in %
    reorder: str = "identity"       # row-permutation scheme baked into vals
    n_shards: int = 1               # 1 = whole matrix

    @property
    def row_loop_sched_len(self) -> int:
        return self.n_block_rows * max(self.max_bpr, 0)


_BACKEND_ALIASES = {"pallas": "nnz_stream"}
BACKENDS = ("nnz_stream", "row_loop", "xla", "dense")
OPS = ("spmm", "sddmm")


@dataclasses.dataclass(frozen=True)
class SpmmConfig:
    backend: str = "nnz_stream"     # nnz_stream | row_loop | xla | dense
    bn: Optional[int] = None        # the SpMM kernels' N tile (None: theirs)
    out_dtype: Optional[torch.dtype] = None


def kernel_tiles(backend: str, op: str = "spmm") -> Tuple[int, ...]:
    """The N tiles ``backend``'s CUDA kernel for ``op`` compiles, so the
    values an explicit ``bn`` may take; () for the plain backends.  The
    SDDMM kernels loop over N in chunks of one fixed width."""
    if backend not in ("nnz_stream", "row_loop"):
        return ()
    return pk.SPMM_TILES if op == "spmm" else pk.SDDMM_TILES


# --------------------------------------------------------- row_loop schedule
def _row_loop_schedule(row_ids: np.ndarray, col_ids: np.ndarray,
                       n_block_rows: int, max_bpr: int):
    """``(flat_idx, flat_col, row_len)`` of the static SpMM schedule from
    the sorted row-major entry list: slot t of block-row i holds entry
    ``flat_idx[i * max_bpr + t]`` and its block-col; padding slots point at
    entry 0 / column 0 and are masked by ``t < row_len[i]``.  Equal to the
    JAX package's traced builder (``repro.kernels.ops._row_loop_schedule``).
    """
    nnzb = row_ids.shape[0]
    row_len = np.bincount(row_ids, minlength=n_block_rows).astype(np.int32)
    rowptr = np.concatenate([[0], np.cumsum(row_len)])
    slot = np.arange(nnzb, dtype=np.int32) - rowptr[row_ids].astype(np.int32)
    pos = row_ids * max_bpr + slot
    flat_idx = np.zeros(n_block_rows * max_bpr, np.int32)
    flat_idx[pos] = np.arange(nnzb, dtype=np.int32)
    flat_col = np.zeros(n_block_rows * max_bpr, np.int32)
    flat_col[pos] = col_ids
    return flat_idx, flat_col, row_len


def _sddmm_row_loop_schedule(row_ids: np.ndarray, col_ids: np.ndarray,
                             n_block_rows: int, max_bpr: int):
    """``(flat_idx, flat_col)`` of the static SDDMM schedule: per (row,
    slot), the OUTPUT entry and its block-col.  Padding slots point at the
    sentinel entry ``nnzb``: the TPU kernel computes and discards their
    product (the static waste of the ``row_loop`` family); on the card
    kernel B4 exits on them before any load, and the plain version
    computes them and drops the sentinel.  Equal to
    ``repro.kernels.ops._sddmm_row_loop_schedule``."""
    flat_idx, flat_col, row_len = _row_loop_schedule(
        row_ids, col_ids, n_block_rows, max_bpr)
    slot = np.arange(max_bpr, dtype=np.int32)
    padding = (slot[None, :] >= row_len[:, None]).reshape(-1)
    flat_idx[padding] = row_ids.shape[0]
    return flat_idx, flat_col


def make_row_loop_schedule(a: bcsr_lib.BCSR):
    """Host-side padded ``(flat_idx, flat_col, row_len, max_bpr)`` of the
    static SpMM schedule of ``a`` (``max_bpr`` at least 1), through
    ``_row_loop_schedule``."""
    bpr = a.blocks_per_row()
    max_bpr = max(int(bpr.max()) if bpr.size else 1, 1)
    row_ids = np.repeat(np.arange(a.n_block_rows, dtype=np.int32), bpr)
    flat_idx, flat_col, row_len = _row_loop_schedule(
        row_ids, a.col_ids, a.n_block_rows, max_bpr)
    return flat_idx, flat_col, row_len, max_bpr


def port_fields(row_ids: np.ndarray, col_ids: np.ndarray,
                t_row_ids: np.ndarray, n_block_rows: int, n_block_cols: int,
                max_bpr: int) -> dict:
    """The ``PORT_FIELDS`` of an operand, from the JAX package's fields:
    the padded entry list (``row_ids``, ``col_ids``), the transpose
    structure's rows and the meta's ``max_bpr``."""
    flat_idx, flat_col, row_len = _row_loop_schedule(
        row_ids, col_ids, n_block_rows, max_bpr)
    sddmm_flat_idx, _ = _sddmm_row_loop_schedule(
        row_ids, col_ids, n_block_rows, max_bpr)
    return {"rowptr": bcsr_lib.rowptr_from_rows(row_ids, n_block_rows),
            "t_rowptr": bcsr_lib.rowptr_from_rows(t_row_ids, n_block_cols),
            "flat_idx": flat_idx, "flat_col": flat_col, "row_len": row_len,
            "sddmm_flat_idx": sddmm_flat_idx}


# ------------------------------------------------------------------- prepare
def _prepare_sparse_host(a: bcsr_lib.BCSR, *, reorder: str,
                         reorder_granularity: str, tau: float,
                         max_candidates: Optional[int], n_shards: int):
    """Host-side (numpy) portion of ``prepare_sparse``: permute, pad,
    build the transpose structure and the ``row_loop`` schedules, and
    compute the static meta.  Returns ``(host_arrays_dict, meta)``.  (The
    JAX package also records trace spans and metrics here; ``obs`` is not
    ported yet.)"""
    a, row_perm_np = permute_lib.permute_bcsr(
        a, reorder, tau=tau, max_candidates=max_candidates,
        n_shards=n_shards, granularity=reorder_granularity)
    # padding entries are tagged explicitly by ensure_nonempty_rows (before
    # its lexsort), so genuinely-zero original blocks keep real_mask=True
    a_p, real_mask = a.ensure_nonempty_rows(return_mask=True)

    # ---- transpose structure (entries of A^T in A^T row-major order) ----
    order = np.lexsort((a_p.row_ids, a_p.col_ids))
    t_perm = order.astype(np.int32)
    t_row_ids = a_p.col_ids[order].astype(np.int32)
    t_col_ids = a_p.row_ids[order].astype(np.int32)
    # pad A^T's empty block-rows with the sentinel zero block (index nnzb)
    n_brows_t = a_p.n_block_cols
    present = np.zeros(n_brows_t, dtype=bool)
    present[t_row_ids] = True
    empty = np.flatnonzero(~present).astype(np.int32)
    if empty.size:
        t_perm = np.concatenate(
            [t_perm, np.full(empty.size, a_p.nnzb, np.int32)])
        t_row_ids = np.concatenate([t_row_ids, empty])
        t_col_ids = np.concatenate([t_col_ids,
                                    np.zeros(empty.size, np.int32)])
        order_t = np.lexsort((t_col_ids, t_row_ids))
        t_perm, t_row_ids, t_col_ids = (
            t_perm[order_t], t_row_ids[order_t], t_col_ids[order_t])

    max_bpr, pad_pct, cv_pct = a_p.dispatch_stats()
    host = {
        "vals": a_p.vals,
        "row_ids": a_p.row_ids,
        "col_ids": a_p.col_ids,
        "real_mask": real_mask,
        "t_perm": t_perm,
        "t_row_ids": t_row_ids,
        "t_col_ids": t_col_ids,
        "row_perm": row_perm_np,
        "inv_perm": permute_lib.invert_perm(row_perm_np),
        **port_fields(a_p.row_ids, a_p.col_ids, t_row_ids, a_p.n_block_rows,
                      n_brows_t, max_bpr),
    }
    meta = SparseMeta(shape=a_p.shape, block=a_p.block,
                      n_block_rows=a_p.n_block_rows,
                      n_block_cols=a_p.n_block_cols,
                      nnzb=a_p.nnzb, nnzb_t=int(t_row_ids.shape[0]),
                      max_bpr=max_bpr, padding_ratio_pct=pad_pct,
                      bpr_cv_pct=cv_pct, reorder=reorder)
    return host, meta


def prepare_sparse(a: bcsr_lib.BCSR, dtype=torch.bfloat16, *,
                   reorder: str = "identity",
                   reorder_granularity: str = "element",
                   tau: float = 0.7, max_candidates: Optional[int] = None,
                   n_shards: int = 8,
                   device="cuda") -> Tuple[SparseArrays, SparseMeta]:
    """Host BCSR -> kernel-ready device tensors on ``device`` + static meta.

    ``reorder`` applies a block-densifying row permutation first (any
    scheme in ``core.permute.SCHEMES`` that yields a pure row permutation:
    ``jaccard`` | ``rcm`` | ``shard_balance`` | ``identity``; ``tau`` and
    ``max_candidates`` tune the Jaccard clustering, ``n_shards`` the
    shard balance).  It is transparent downstream: ``spmm`` un-permutes
    its output and the gradients carry the permutation, so results match
    ``reorder="identity"``.  ``reorder_granularity="element"`` re-blocks
    the permuted nonzero structure (stored zero blocks do not survive);
    ``"block_row"`` permutes whole block-rows (nnzb and every stored entry
    kept: the model-weight path).  The meta carries the post-reorder
    structure stats, which the ``row_loop`` schedules are sized by.

    >>> import numpy as np, torch
    >>> from repro_torch.core import bcsr as bcsr_lib
    >>> from repro_torch.kernels import ops
    >>> dense = np.kron(np.eye(4, dtype=np.float32), np.ones((8, 8)))
    >>> a = bcsr_lib.from_dense(dense.astype(np.float32), (8, 8))
    >>> arrays, meta = ops.prepare_sparse(a, torch.float32, device="cpu")
    >>> (meta.nnzb, meta.max_bpr, meta.row_loop_sched_len)
    (4, 1, 4)
    """
    host, meta = _prepare_sparse_host(
        a, reorder=reorder, reorder_granularity=reorder_granularity, tau=tau,
        max_candidates=max_candidates, n_shards=n_shards)

    def dev(x, dt=torch.int32):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

    arrays = SparseArrays(
        vals=dev(host["vals"], dtype),
        row_ids=dev(host["row_ids"]),
        col_ids=dev(host["col_ids"]),
        real_mask=dev(host["real_mask"], torch.bool),
        t_perm=dev(host["t_perm"]),
        t_row_ids=dev(host["t_row_ids"]),
        t_col_ids=dev(host["t_col_ids"]),
        row_perm=dev(host["row_perm"]),
        inv_perm=dev(host["inv_perm"]),
        **{name: dev(host[name]) for name in PORT_FIELDS},
    )
    return arrays, meta


def prepare_sparse_meta(a: bcsr_lib.BCSR, *, reorder: str = "identity",
                        reorder_granularity: str = "element",
                        tau: float = 0.7,
                        max_candidates: Optional[int] = None,
                        n_shards: int = 8) -> SparseMeta:
    """The static meta ``prepare_sparse`` would return, without building
    device tensors (same host pipeline, so equal by construction)."""
    return _prepare_sparse_host(
        a, reorder=reorder, reorder_granularity=reorder_granularity, tau=tau,
        max_candidates=max_candidates, n_shards=n_shards)[1]


def prepare(a: bcsr_lib.BCSR, dtype=torch.bfloat16, *,
            meta_only: bool = False, reorder: str = "identity",
            reorder_granularity: str = "element", tau: float = 0.7,
            max_candidates: Optional[int] = None, n_shards: int = 8,
            device="cuda"):
    """``(SparseArrays, SparseMeta)`` of ``a`` on ``device``, or the
    ``SparseMeta`` alone with ``meta_only=True``.

    >>> import numpy as np, torch
    >>> from repro_torch.core import bcsr as bcsr_lib
    >>> from repro_torch.kernels import ops
    >>> dense = np.kron(np.eye(4, dtype=np.float32), np.ones((8, 8)))
    >>> a = bcsr_lib.from_dense(dense, (8, 8))
    >>> arrays, meta = ops.prepare(a, torch.float32, device="cpu")
    >>> ops.prepare(a, meta_only=True) == meta
    True
    """
    kw = dict(reorder=reorder, reorder_granularity=reorder_granularity,
              tau=tau, max_candidates=max_candidates, n_shards=n_shards)
    if meta_only:
        return prepare_sparse_meta(a, **kw)
    return prepare_sparse(a, dtype, device=device, **kw)


# ------------------------------------------------------------------- forward
def materialize_dense(arrays: SparseArrays, meta: SparseMeta) -> torch.Tensor:
    """Scatter the blocks into the padded dense matrix."""
    h, w = meta.block
    nbr, nbc = meta.n_block_rows, meta.n_block_cols
    flat = torch.zeros((nbr * nbc, h, w), dtype=arrays.vals.dtype,
                       device=arrays.vals.device)
    flat.index_add_(0, (arrays.row_ids * nbc + arrays.col_ids).long(),
                    arrays.vals)
    dense = flat.reshape(nbr, nbc, h, w).permute(0, 2, 1, 3)
    return dense.reshape(nbr * h, nbc * w)


def _fwd_impl(cfg: SpmmConfig, meta: SparseMeta, arrays: SparseArrays,
              b: torch.Tensor) -> torch.Tensor:
    h, w = meta.block
    M, K = meta.shape
    out_dtype = cfg.out_dtype or b.dtype
    k_pad = meta.n_block_cols * w - b.shape[0]
    if k_pad:
        # the kernel reads whole w-row panels of B; N is never padded (the
        # kernel masks its ragged N edge itself)
        b = torch.nn.functional.pad(b, (0, 0, 0, k_pad))
    if cfg.backend == "nnz_stream":
        out = pk.bcsr_spmm_nnz_stream(
            arrays.vals, arrays.row_ids, arrays.col_ids, b,
            meta.n_block_rows, rowptr=arrays.rowptr, bn=cfg.bn,
            out_dtype=out_dtype)
    elif cfg.backend == "row_loop":
        _check_schedule(arrays, "flat_idx")
        out = pk.bcsr_spmm_row_loop(
            arrays.vals, arrays.flat_idx, arrays.flat_col, arrays.row_len, b,
            meta.n_block_rows, bn=cfg.bn, out_dtype=out_dtype)
    elif cfg.backend == "xla":
        out = ref.bcsr_spmm_ref(arrays.vals, arrays.row_ids, arrays.col_ids,
                                b, meta.n_block_rows, out_dtype=out_dtype)
    elif cfg.backend == "dense":
        dense = materialize_dense(arrays, meta)
        out = ref.spmm_dense_ref(dense, b, out_dtype=out_dtype)
    else:
        raise ValueError(f"unknown backend {cfg.backend!r}")
    out = out[:M]
    if meta.reorder != "identity" and arrays.inv_perm is not None:
        # the kernel computed C' = A' B in permuted row order; hand back
        # C = P^T C' so the permutation never leaks to callers
        out = out.index_select(0, arrays.inv_perm.long())
    return out


def _check_schedule(arrays: SparseArrays, field: str) -> None:
    if getattr(arrays, field) is None:
        raise ValueError(
            f"backend='row_loop' reads the static schedule ({field!r}), which "
            "ops.prepare builds; this SparseArrays has none")


def transposed_vals(vals: torch.Tensor, t_perm: torch.Tensor) -> torch.Tensor:
    """The blocks of A^T in the transpose structure's order, [nnzb_t, w, h]
    contiguous: ``vals[t_perm]`` transposed, where ``t_perm == nnzb`` picks
    the sentinel zero block of an empty block-row of A^T."""
    sentinel = vals.new_zeros((1,) + tuple(vals.shape[1:]))
    t_vals = torch.cat([vals, sentinel])[t_perm.long()]
    return t_vals.transpose(1, 2).contiguous()


def _dx_impl(cfg: SpmmConfig, meta: SparseMeta, arrays: SparseArrays,
             g: torch.Tensor) -> torch.Tensor:
    """dB = A^T @ g through the stored transpose structure, [nbc*w, N]: the
    SpMM kernel over ``t_row_ids``/``t_col_ids``/``t_rowptr`` with the
    blocks of ``transposed_vals``.  ``g`` [M, N] may be a strided view; its
    rows are padded to ``n_block_rows * h``, since the kernel reads whole
    h-row panels."""
    h, w = meta.block
    vals = arrays.vals
    # row_loop is a forward-schedule choice; the backward always streams the
    # transpose structure (whose row skew differs from A's), as in JAX
    kernel = cfg.backend in ("nnz_stream", "row_loop")
    if (kernel and g.is_cuda and torch.is_grad_enabled()
            and (g.requires_grad or vals.requires_grad)):
        # the kernel's output carries no graph; the JAX package's Pallas
        # kernel has no JVP rule either, so higher derivatives run on xla
        raise NotImplementedError(
            "a derivative of dB = A^T dC through the streamed kernel is not "
            "supported; take higher derivatives with backend='xla'")
    t_vals = transposed_vals(vals, arrays.t_perm)
    m_pad = meta.n_block_rows * h - g.shape[0]
    if m_pad:
        g = F.pad(g, (0, 0, 0, m_pad))
    if kernel:
        return pk.bcsr_spmm_nnz_stream(
            t_vals, arrays.t_row_ids, arrays.t_col_ids, g, meta.n_block_cols,
            rowptr=arrays.t_rowptr, bn=cfg.bn, out_dtype=g.dtype)
    return ref.bcsr_spmm_ref(t_vals, arrays.t_row_ids, arrays.t_col_ids, g,
                             meta.n_block_cols, out_dtype=g.dtype)


def _sddmm_impl(cfg: SpmmConfig, meta: SparseMeta, arrays: SparseArrays,
                x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """vals[s] = X'[block row_ids[s]] @ Y[block col_ids[s]]^T — the dense
    pair sampled at the stored structure (X' = P X when the structure was
    prepared with a reorder; callers pass X in ORIGINAL row order).  X is
    padded to ``n_block_rows * h`` rows and Y to ``n_block_cols * w``; N is
    never padded (the kernel masks its ragged N edge).  Padding entries
    (``real_mask`` False) are zeroed: they are structural, not values."""
    h, w = meta.block
    if meta.reorder != "identity" and arrays.row_perm is not None:
        x = x.index_select(0, arrays.row_perm.long())
    out_dtype = cfg.out_dtype or x.dtype
    x_pad = meta.n_block_rows * h - x.shape[0]
    y_pad = meta.n_block_cols * w - y.shape[0]
    if x_pad:
        x = F.pad(x, (0, 0, 0, x_pad))
    if y_pad:
        y = F.pad(y, (0, 0, 0, y_pad))
    if cfg.backend == "nnz_stream":
        vals = pk.bcsr_sddmm(x, y, arrays.row_ids, arrays.col_ids, h, w,
                             out_dtype=out_dtype)
    elif cfg.backend == "row_loop":
        _check_schedule(arrays, "sddmm_flat_idx")
        vals = pk.bcsr_sddmm_row_loop(
            x, y, arrays.sddmm_flat_idx, arrays.flat_col, meta.n_block_rows,
            meta.nnzb, h, w, out_dtype=out_dtype)
    elif cfg.backend == "xla":
        vals = ref.bcsr_sddmm_ref(x, y, arrays.row_ids, arrays.col_ids, h, w,
                                  out_dtype=out_dtype)
    elif cfg.backend == "dense":
        vals = ref.bcsr_sddmm_dense_ref(x, y, arrays.row_ids, arrays.col_ids,
                                        h, w, out_dtype=out_dtype)
    else:
        raise ValueError(f"unknown backend {cfg.backend!r}")
    # padding entries are structural zeros — never values, never gradients
    return vals * arrays.real_mask[:, None, None].to(vals.dtype)


# ---------------------------------------------------------------- autograd
# ``rest`` is ``tuple(arrays[1:])``: the index tensors, never differentiated.
# Where one op's backward calls the other, ``bn`` is dropped: it names a
# tile of the calling op's kernel, and each kernel then takes its own.
class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, meta, rest, vals, b):
        ctx.cfg, ctx.meta, ctx.rest = cfg, meta, rest
        ctx.save_for_backward(vals, b)
        return _fwd_impl(cfg, meta, SparseArrays(vals, *rest), b)

    @staticmethod
    def backward(ctx, g):
        vals, b = ctx.saved_tensors
        cfg, meta, rest = ctx.cfg, ctx.meta, ctx.rest
        arrays = SparseArrays(vals, *rest)
        g2 = g.to(b.dtype)
        dvals = db = None
        if ctx.needs_input_grad[4]:
            gp = g2
            if meta.reorder != "identity" and arrays.row_perm is not None:
                # the cotangent arrives in ORIGINAL row order; the stored
                # structure is A' = P A, so dB = A'^T (P dC)
                gp = g2.index_select(0, arrays.row_perm.long())
            db = _dx_impl(cfg, meta, arrays, gp)[: b.shape[0], : b.shape[1]]
        if ctx.needs_input_grad[3]:
            # dvals through the SDDMM op: SpMM and SDDMM are mutual duals
            cfg_d = dataclasses.replace(cfg, bn=None, out_dtype=vals.dtype)
            dvals = _Sddmm.apply(cfg_d, meta, rest, g2, b)
        return None, None, None, dvals, db


class _Sddmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, meta, rest, x, y):
        ctx.cfg, ctx.meta, ctx.rest = cfg, meta, rest
        ctx.save_for_backward(x, y)
        # the vals slot is unused by the sampling
        return _sddmm_impl(cfg, meta, SparseArrays(None, *rest), x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        cfg, meta, rest = ctx.cfg, ctx.meta, ctx.rest
        gm = g * SparseArrays(None, *rest).real_mask[:, None, None].to(
            g.dtype)
        cfg_b = dataclasses.replace(cfg, bn=None, out_dtype=None)
        dx = dy = None
        if ctx.needs_input_grad[3]:
            # dX = G @ Y: the SpMM forward on the cotangent blocks (the op
            # un-permutes back to original row order itself)
            dx = _Spmm.apply(cfg_b, meta, rest, gm.to(y.dtype), y).to(x.dtype)
        if ctx.needs_input_grad[4]:
            # dY = G^T @ X' through the stored transpose structure
            garr = SparseArrays(gm.to(y.dtype), *rest)
            xp = x
            if meta.reorder != "identity" and garr.row_perm is not None:
                xp = x.index_select(0, garr.row_perm.long())
            dy = _dx_impl(cfg_b, meta, garr, xp)[: y.shape[0], : y.shape[1]]
            dy = dy.to(y.dtype)
        return None, None, None, dx, dy


def _needs_graph(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ------------------------------------------------------------------ public API
def resolve_backend(backend: str, bn: Optional[int], meta: SparseMeta,
                    n: int, op: str = "spmm",
                    device="cuda") -> Tuple[str, Optional[int]]:
    """Normalize aliases, resolve ``auto`` and check the choice: returns
    ``(backend, bn)``.

    ``auto`` asks ``autotune.get_autotuner().pick`` for the ``op`` family
    (``"spmm"`` | ``"sddmm"``) on ``device`` (the device is part of the
    cache key, so a pick measured on one device never serves another); the
    pick is always one of the two kernel backends, and a cached
    ``row_loop`` pick for a meta without ``max_bpr`` falls back to
    ``nnz_stream``.  ``bn`` is the SpMM kernels' N tile: None (or 0) lets
    the kernel choose, otherwise it must be one of ``kernel_tiles(backend,
    op)``.  An explicit ``row_loop`` for a meta without ``max_bpr``
    raises."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; want 'spmm' or 'sddmm'")
    if backend == "auto":
        from repro_torch.kernels import autotune  # local: autotune imports ops
        choice = autotune.get_autotuner().pick(meta, n, op=op, device=device)
        backend, bn = choice.backend, choice.bn
        if backend == "row_loop" and meta.max_bpr <= 0:
            backend = "nnz_stream"   # stale cached pick for a specs meta
    backend = _BACKEND_ALIASES.get(backend, backend)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of "
                         f"{BACKENDS + ('auto', 'pallas')}")
    if backend == "row_loop" and meta.max_bpr <= 0:
        # an explicit request we cannot honor: raising beats silently
        # timing a different kernel than the caller asked for
        raise ValueError(
            "backend='row_loop' needs meta.max_bpr > 0 (metas built by "
            "prepare / prepare_sparse_meta have it; hand-built metas do not)")
    if not bn:
        bn = None
    elif bn not in kernel_tiles(backend, op):
        raise ValueError(
            f"bn={bn} is not an N tile the {backend} {op} kernel compiles; "
            f"want None or one of {kernel_tiles(backend, op)}")
    return backend, bn


def spmm(arrays: SparseArrays, meta: SparseMeta, b: torch.Tensor,
         *, backend: str = "nnz_stream", bn: Optional[int] = None,
         out_dtype=None) -> torch.Tensor:
    """C = A @ B, differentiable w.r.t. ``arrays.vals`` and ``b``.

    A is the BCSR operand from ``prepare``; B is ``[K, N]`` dense and may be
    a strided view.  Outputs come back in ORIGINAL row order, whatever
    ``reorder`` prepared A.  ``bn`` is the kernel's N tile
    (``resolve_backend``).

    >>> import numpy as np, torch
    >>> from repro_torch.core import bcsr as bcsr_lib
    >>> from repro_torch.kernels import ops
    >>> rng = np.random.default_rng(0)
    >>> dense = np.kron(rng.random((4, 4)) < 0.5,
    ...                 np.ones((8, 8))).astype(np.float32)
    >>> a = bcsr_lib.from_dense(dense, (8, 8))
    >>> arrays, meta = ops.prepare(a, torch.float32, device="cpu")
    >>> b = torch.as_tensor(rng.standard_normal((32, 16)), dtype=torch.float32)
    >>> c = ops.spmm(arrays, meta, b)
    >>> c.shape
    torch.Size([32, 16])
    >>> bool(torch.allclose(c, torch.as_tensor(dense) @ b, atol=1e-5))
    True
    """
    backend, bn = resolve_backend(backend, bn, meta, int(b.shape[-1]),
                                  device=b.device)
    cfg = SpmmConfig(backend=backend, bn=bn, out_dtype=out_dtype)
    if _needs_graph(arrays.vals, b):
        return _Spmm.apply(cfg, meta, tuple(arrays[1:]), arrays.vals, b)
    return _fwd_impl(cfg, meta, arrays, b)


def sddmm(arrays: SparseArrays, meta: SparseMeta, x: torch.Tensor,
          y: torch.Tensor, *, backend: str = "nnz_stream",
          bn: Optional[int] = None, out_dtype=None) -> torch.Tensor:
    """Sampled dense-dense product: the blocks of ``X @ Y^T`` stored by the
    structure of ``(arrays, meta)``, SpMM's dual.  ``X`` is ``[M, N]``
    (original row order), ``Y`` is ``[K, N]``; both may be strided views.
    The result is ``[nnzb, h, w]`` with padding entries (``real_mask``
    False) zeroed.  Differentiable w.r.t. ``x`` and ``y``; ``arrays.vals``
    is not read.  ``bn`` is checked as ``resolve_backend`` says; the SDDMM
    kernels have one N chunk each.

    >>> import numpy as np, torch
    >>> from repro_torch.core import bcsr as bcsr_lib
    >>> from repro_torch.kernels import ops
    >>> rng = np.random.default_rng(0)
    >>> dense = np.kron(rng.random((4, 4)) < 0.5,
    ...                 np.ones((8, 8))).astype(np.float32)
    >>> a = bcsr_lib.from_dense(dense, (8, 8))
    >>> arrays, meta = ops.prepare(a, torch.float32, device="cpu")
    >>> x = torch.as_tensor(rng.standard_normal((32, 16)), dtype=torch.float32)
    >>> y = torch.as_tensor(rng.standard_normal((32, 16)), dtype=torch.float32)
    >>> vals = ops.sddmm(arrays, meta, x, y)
    >>> vals.shape == (meta.nnzb, 8, 8)
    True
    >>> full = (x @ y.T).reshape(4, 8, 4, 8).permute(0, 2, 1, 3)
    >>> blk = full[arrays.row_ids.long(), arrays.col_ids.long()]
    >>> blk = blk * arrays.real_mask[:, None, None]       # padding -> 0
    >>> bool(torch.allclose(vals, blk, atol=1e-4))
    True
    """
    backend, bn = resolve_backend(backend, bn, meta, int(x.shape[-1]),
                                  op="sddmm", device=x.device)
    cfg = SpmmConfig(backend=backend, bn=bn, out_dtype=out_dtype)
    if _needs_graph(x, y):
        return _Sddmm.apply(cfg, meta, tuple(arrays[1:]), x, y)
    return _sddmm_impl(cfg, meta, arrays, x, y)
