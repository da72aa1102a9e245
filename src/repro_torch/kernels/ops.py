"""The SpMM/SDDMM op pair: kernel-ready BCSR operands, backend dispatch and
the two mutually dual gradients.

``prepare`` turns a host ``BCSR`` into the device tensors of a
``SparseArrays`` (entries padded so every block-row is nonempty, plus the
transpose structure the backward reads) and a static ``SparseMeta``.
``spmm`` computes C = A @ B and ``sddmm`` the blocks of X @ Y^T stored by
A's structure, each through one of:

  * ``nnz_stream`` — the hand-written CUDA kernels (``bcsr_spmm_nnz_stream``,
    ``kernels/csrc/bcsr_spmm.cu``, for spmm and for dB = A^T dC over the
    transpose structure; ``bcsr_sddmm``, ``kernels/csrc/bcsr_sddmm.cu``, for
    sddmm and so for dvals); ``pallas`` is accepted as an alias, the JAX
    package's name.  On a CPU tensor the wrappers run the plain versions.
  * ``xla``        — the plain PyTorch versions (``kernels/ref.py``), only
    when a caller names them.
  * ``dense``      — materialize the dense operand (or product) and multiply.
  * ``auto``       — resolves to ``nnz_stream`` until the autotuner is ported.

``row_loop`` is not ported yet and raises.  Both ops are differentiable:
``spmm``'s backward gives dB through the transpose structure and dvals
through ``sddmm``; ``sddmm``'s gives dX through ``spmm`` and dY through the
transpose structure, so higher derivatives bounce between the two
``torch.autograd.Function``s, as the JAX package's custom VJPs do.  Without
grad (serving runs under ``torch.inference_mode()``) the ops call their
forward directly and add no autograd work.
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
    them element for element.  ``rowptr`` and ``t_rowptr`` (``PORT_FIELDS``)
    are the port's own: the SpMM kernel reads each block-row's entry range
    from them, of A in the forward and of A^T in the backward."""
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


# the fields the JAX package does not have, rebuilt from the others
PORT_FIELDS = ("rowptr", "t_rowptr")


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
BACKENDS = ("nnz_stream", "xla", "dense")


@dataclasses.dataclass(frozen=True)
class SpmmConfig:
    backend: str = "nnz_stream"     # nnz_stream | xla | dense
    out_dtype: Optional[torch.dtype] = None


# ------------------------------------------------------------------- prepare
def _prepare_sparse_host(a: bcsr_lib.BCSR, *, reorder: str,
                         reorder_granularity: str):
    """Host-side (numpy) portion of ``prepare_sparse``: permute, pad,
    build the transpose structure, and compute the static meta.  Returns
    ``(host_arrays_dict, meta)``.  (The JAX package also records trace
    spans and metrics here; ``obs`` is not ported yet.)"""
    a, row_perm_np = permute_lib.permute_bcsr(
        a, reorder, granularity=reorder_granularity)
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
        "rowptr": a_p.rowptr,
        "t_rowptr": bcsr_lib.rowptr_from_rows(t_row_ids, n_brows_t),
    }
    max_bpr, pad_pct, cv_pct = a_p.dispatch_stats()
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
                   device="cuda") -> Tuple[SparseArrays, SparseMeta]:
    """Host BCSR -> kernel-ready device tensors on ``device`` + static meta.

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
        a, reorder=reorder, reorder_granularity=reorder_granularity)

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
        rowptr=dev(host["rowptr"]),
        t_rowptr=dev(host["t_rowptr"]),
    )
    return arrays, meta


def prepare_sparse_meta(a: bcsr_lib.BCSR, *, reorder: str = "identity",
                        reorder_granularity: str = "element") -> SparseMeta:
    """The static meta ``prepare_sparse`` would return, without building
    device tensors (same host pipeline, so equal by construction)."""
    return _prepare_sparse_host(
        a, reorder=reorder, reorder_granularity=reorder_granularity)[1]


def prepare(a: bcsr_lib.BCSR, dtype=torch.bfloat16, *,
            meta_only: bool = False, reorder: str = "identity",
            reorder_granularity: str = "element", device="cuda"):
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
    if meta_only:
        return prepare_sparse_meta(a, reorder=reorder,
                                   reorder_granularity=reorder_granularity)
    return prepare_sparse(a, dtype, reorder=reorder,
                          reorder_granularity=reorder_granularity,
                          device=device)


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
            meta.n_block_rows, rowptr=arrays.rowptr, out_dtype=out_dtype)
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
    if (cfg.backend == "nnz_stream" and g.is_cuda and torch.is_grad_enabled()
            and (g.requires_grad or vals.requires_grad)):
        # the kernel's output carries no graph; the JAX package's Pallas
        # kernel has no JVP rule either, so higher derivatives run on xla
        raise NotImplementedError(
            "a derivative of dB = A^T dC through the nnz_stream kernel is not "
            "supported; take higher derivatives with backend='xla'")
    t_vals = transposed_vals(vals, arrays.t_perm)
    m_pad = meta.n_block_rows * h - g.shape[0]
    if m_pad:
        g = F.pad(g, (0, 0, 0, m_pad))
    if cfg.backend == "nnz_stream":
        return pk.bcsr_spmm_nnz_stream(
            t_vals, arrays.t_row_ids, arrays.t_col_ids, g, meta.n_block_cols,
            rowptr=arrays.t_rowptr, out_dtype=g.dtype)
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
# The ``meta.reorder != "identity"`` branches mirror the JAX package's; only
# the identity scheme is ported so far, so they run untested until the
# reorder schemes are (ROADMAP A3).
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
            cfg_d = dataclasses.replace(cfg, out_dtype=vals.dtype)
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
        cfg_b = dataclasses.replace(cfg, out_dtype=None)
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
def resolve_backend(backend: str, op: str = "spmm") -> str:
    """Normalize aliases; ``auto`` resolves to ``nnz_stream`` for either
    ``op`` (``"spmm"`` | ``"sddmm"``) until the autotuner is ported.  (The
    JAX package's N-tile ``bn`` is not a choice here: the kernels pick their
    own tiles.)"""
    if op not in ("spmm", "sddmm"):
        raise ValueError(f"unknown op {op!r}; want 'spmm' or 'sddmm'")
    if backend == "auto":
        backend = "nnz_stream"
    backend = _BACKEND_ALIASES.get(backend, backend)
    if backend == "row_loop":
        raise NotImplementedError(
            "backend='row_loop' is not yet ported to the GPU")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of "
                         f"{BACKENDS + ('auto', 'pallas')}")
    return backend


def spmm(arrays: SparseArrays, meta: SparseMeta, b: torch.Tensor,
         *, backend: str = "nnz_stream", out_dtype=None) -> torch.Tensor:
    """C = A @ B, differentiable w.r.t. ``arrays.vals`` and ``b``.

    A is the BCSR operand from ``prepare``; B is ``[K, N]`` dense and may be
    a strided view.  Outputs come back in ORIGINAL row order.

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
    cfg = SpmmConfig(backend=resolve_backend(backend), out_dtype=out_dtype)
    if _needs_graph(arrays.vals, b):
        return _Spmm.apply(cfg, meta, tuple(arrays[1:]), arrays.vals, b)
    return _fwd_impl(cfg, meta, arrays, b)


def sddmm(arrays: SparseArrays, meta: SparseMeta, x: torch.Tensor,
          y: torch.Tensor, *, backend: str = "nnz_stream",
          out_dtype=None) -> torch.Tensor:
    """Sampled dense-dense product: the blocks of ``X @ Y^T`` stored by the
    structure of ``(arrays, meta)``, SpMM's dual.  ``X`` is ``[M, N]``
    (original row order), ``Y`` is ``[K, N]``; both may be strided views.
    The result is ``[nnzb, h, w]`` with padding entries (``real_mask``
    False) zeroed.  Differentiable w.r.t. ``x`` and ``y``; ``arrays.vals``
    is not read.

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
    cfg = SpmmConfig(backend=resolve_backend(backend, op="sddmm"),
                     out_dtype=out_dtype)
    if _needs_graph(x, y):
        return _Sddmm.apply(cfg, meta, tuple(arrays[1:]), x, y)
    return _sddmm_impl(cfg, meta, arrays, x, y)
