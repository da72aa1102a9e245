"""The SpMM op: kernel-ready BCSR operands and backend dispatch.

``prepare`` turns a host ``BCSR`` into the device tensors of a
``SparseArrays`` (entries padded so every block-row is nonempty, plus the
transpose structure the training slice's backward will read) and a static
``SparseMeta``.  ``spmm`` computes C = A @ B through one of:

  * ``nnz_stream`` — the hand-written CUDA kernel
    (``kernels/csrc/bcsr_spmm.cu``); ``pallas`` is accepted as an alias, the
    JAX package's name for the same kernel.  On a CPU tensor its wrapper runs
    the plain version.
  * ``xla``        — the plain PyTorch version (``ref.bcsr_spmm_ref``), only
    when a caller names it.
  * ``dense``      — materialize the padded dense matrix and multiply.
  * ``auto``       — resolves to ``nnz_stream`` until the autotuner is ported.

``row_loop`` is not ported yet and raises.  This slice serves only: ``spmm``
is a forward function and raises where autograd would need its backward.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bcsr as bcsr_lib
from repro_torch.core import permute as permute_lib
from repro_torch.kernels import bcsr_spmm as pk
from repro_torch.kernels import ref


# ---------------------------------------------------------------------- types
class SparseArrays(NamedTuple):
    """Device tensors of a BCSR operand.

    The fields up to ``inv_perm`` are those of the JAX package, equal to
    them element for element.  ``rowptr`` is the port's own: the CUDA kernel
    reads each block-row's entry range from it."""
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


# ------------------------------------------------------------------ public API
def resolve_backend(backend: str) -> str:
    """Normalize aliases; ``auto`` resolves to ``nnz_stream`` until the
    autotuner is ported.  (The JAX package's N-tile ``bn`` is not a choice
    here: the kernel picks its own N tile, ``bcsr_spmm.tile_n``.)"""
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
    """C = A @ B (forward only in this slice).

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
    if torch.is_grad_enabled() and (arrays.vals.requires_grad
                                    or b.requires_grad):
        raise NotImplementedError(
            "spmm has no backward yet (it comes with the training slice); "
            "call it under torch.no_grad() or torch.inference_mode()")
    cfg = SpmmConfig(backend=resolve_backend(backend), out_dtype=out_dtype)
    return _fwd_impl(cfg, meta, arrays, b)
