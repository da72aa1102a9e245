"""Block-sparse linear layer — the paper's technique as a model layer.

A linear layer ``y = x @ W^T`` whose weight ``W [out, in]`` is stored in BCSR
and multiplied by the SpMM kernel as ``C = W @ x^T``.

Patterns are generated with exact nnzb and full row/col coverage and are
deterministic in a python-int seed (numpy), so the port draws the SAME
structures and ``vals`` as the JAX package, and ``sparse_linear_meta``
re-derives a layer's meta from ``(seed, dims, spec)`` alone.  The
partitioned (``shards``) path is not ported yet and raises.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import bcsr as bcsr_lib
from repro_torch.kernels import ops

# SparseArrays fields a layer keeps as buffers, in the JAX params' key order
# (the JAX package keeps no rowptr or t_rowptr, ``ops.PORT_FIELDS``; the
# port's kernel reads them in the forward and the backward)
BUFFER_FIELDS = ("row_ids", "col_ids", "real_mask", "t_perm", "t_row_ids",
                 "t_col_ids", "row_perm", "inv_perm", "rowptr", "t_rowptr")


@dataclasses.dataclass(frozen=True)
class SparsitySpec:
    """Config for a block-sparse weight.

    The fields are the JAX package's, less ``interpret`` (a Pallas option
    with no meaning on the card).  ``bn`` is kept for config parity; the
    CUDA kernel chooses its own N tile.  ``tune_n``, ``reorder_shards``,
    ``shard_cols`` and ``shard_chunks`` are carried for the slices that use
    them; ``shards`` other than 0 raises."""
    density: float = 0.1            # fraction of nonzero blocks
    block: Tuple[int, int] = (128, 128)
    backend: str = "nnz_stream"     # nnz_stream (alias pallas) | xla | dense | auto
    bn: int = 512
    tune_n: int = 0
    reorder: str = "identity"
    reorder_shards: int = 0
    shards: object = 0
    shard_cols: int = 1
    shard_chunks: int = 2


def _check_unsharded(spec: SparsitySpec) -> None:
    if spec.shards == "auto" or (isinstance(spec.shards, int)
                                 and spec.shards > 0):
        raise NotImplementedError(
            "SparsitySpec.shards (the partitioned SpMM path) is not ported "
            "yet")


def _nnzb_for(spec: SparsitySpec, out_dim: int, in_dim: int) -> int:
    h, w = spec.block
    nbr, nbc = -(-out_dim // h), -(-in_dim // w)
    nnzb = int(round(spec.density * nbr * nbc))
    nnzb = max(nnzb, max(nbr, nbc))
    # rounded up to a multiple of 16, as the JAX package does (there it lets
    # the nnz dimension shard over a mesh axis); capped for tiny matrices
    nnzb = min(-(-nnzb // 16) * 16, nbr * nbc)
    return nnzb


def _pattern_for(seed: int, in_dim: int, out_dim: int,
                 spec: SparsitySpec) -> bcsr_lib.BCSR:
    """THE weight pattern of ``(seed, dims, spec)`` — shared by
    ``init_sparse_linear`` and ``sparse_linear_meta``."""
    return bcsr_lib.random_bcsr_exact(
        seed, (out_dim, in_dim), spec.block,
        _nnzb_for(spec, out_dim, in_dim), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def sparse_linear_meta(seed: int, in_dim: int, out_dim: int,
                       spec: SparsitySpec) -> ops.SparseMeta:
    """True structure meta of the layer ``init_sparse_linear(seed, ...)``
    builds, derived without building tensors (memoized host work)."""
    _check_unsharded(spec)
    a = _pattern_for(seed, in_dim, out_dim, spec)
    return ops.prepare_sparse_meta(a, reorder=spec.reorder,
                                   reorder_granularity="block_row")


def _merge_two(m0: ops.SparseMeta, m1: ops.SparseMeta) -> ops.SparseMeta:
    static0 = dataclasses.replace(m0, max_bpr=0, padding_ratio_pct=0,
                                  bpr_cv_pct=0)
    static1 = dataclasses.replace(m1, max_bpr=0, padding_ratio_pct=0,
                                  bpr_cv_pct=0)
    if static0 != static1:
        raise ValueError(
            f"cannot merge metas with different static structure:\n"
            f"  {static0}\n  {static1}")
    return dataclasses.replace(
        m0, max_bpr=max(m0.max_bpr, m1.max_bpr),
        padding_ratio_pct=max(m0.padding_ratio_pct, m1.padding_ratio_pct),
        bpr_cv_pct=max(m0.bpr_cv_pct, m1.bpr_cv_pct))


def merge_sparse_metas(metas) -> ops.SparseMeta:
    """Conservative merge of per-layer metas into one: the static fields
    must match, the stats take the max.  Raises if they differ."""
    metas = list(metas)
    if not metas:
        raise ValueError("merge_sparse_metas needs at least one meta")
    return functools.reduce(_merge_two, metas)


def init_sparse_linear(key: int, in_dim: int, out_dim: int,
                       spec: SparsitySpec, dtype=torch.bfloat16, *,
                       device="cuda"):
    """Returns ``(params, meta)``: ``params`` a dict of tensors on
    ``device`` (``vals`` plus the index arrays of ``BUFFER_FIELDS``), and
    the static meta, equal to ``sparse_linear_meta(key, ...)``."""
    _check_unsharded(spec)
    a = _pattern_for(key, in_dim, out_dim, spec)
    arrays, meta = ops.prepare_sparse(
        a, dtype, reorder=spec.reorder, reorder_granularity="block_row",
        device=device)
    return arrays._asdict(), meta


def apply_sparse_linear(params, meta: ops.SparseMeta, x: torch.Tensor,
                        spec: SparsitySpec) -> torch.Tensor:
    """y[..., out] = x[..., in] @ W^T via C = W @ x^T.  ``params`` is a
    mapping with the keys ``init_sparse_linear`` returns (or a
    ``SparseLinear``, whose ``params()`` gives one).  The kernel reads the
    transposed view x^T as it is, with no copy."""
    _check_unsharded(spec)
    lead = x.shape[:-1]
    xt = x.reshape(-1, x.shape[-1]).T                # [K, T]
    arrays = ops.SparseArrays(
        vals=params["vals"], row_ids=params["row_ids"],
        col_ids=params["col_ids"], real_mask=params["real_mask"],
        t_perm=params["t_perm"], t_row_ids=params["t_row_ids"],
        t_col_ids=params["t_col_ids"], row_perm=params.get("row_perm"),
        inv_perm=params.get("inv_perm"), rowptr=params.get("rowptr"),
        t_rowptr=params.get("t_rowptr"))
    c = ops.spmm(arrays, meta, xt, backend=spec.backend)   # [M, T]
    return c.T.reshape(*lead, meta.shape[0])


class SparseLinear(nn.Module):
    """A block-sparse linear layer: ``vals`` is its parameter (trained
    through ``ops.spmm``'s backward), the index arrays are buffers, ``meta``
    and ``spec`` are static."""

    def __init__(self, params, meta: ops.SparseMeta, spec: SparsitySpec):
        super().__init__()
        self.meta, self.spec = meta, spec
        self.vals = nn.Parameter(params["vals"])
        for name in BUFFER_FIELDS:
            self.register_buffer(name, params[name])

    def params(self) -> dict:
        return {"vals": self.vals,
                **{name: getattr(self, name) for name in BUFFER_FIELDS}}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_sparse_linear(self.params(), self.meta, x, self.spec)
