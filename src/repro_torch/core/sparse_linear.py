"""Block-sparse linear layer — the paper's technique as a model layer.

A linear layer ``y = x @ W^T`` whose weight ``W [out, in]`` is stored in BCSR
and multiplied by the SpMM kernel as ``C = W @ x^T``.

Patterns are generated with exact nnzb and full row/col coverage and are
deterministic in a python-int seed (numpy), so the port draws the SAME
structures and ``vals`` as the JAX package, and ``sparse_linear_meta``
re-derives a layer's meta from ``(seed, dims, spec)`` alone.  With
``SparsitySpec(shards=...)`` the layer runs the partitioned path
(``launch.dist_spmm``): its buffers are the row partition's, its meta a
``ShardedMeta``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import bcsr as bcsr_lib
from repro_torch.kernels import autotune, ops
from repro_torch.launch.constrain import BATCH, MODEL, constrain

# SparseArrays fields a layer keeps as buffers: the JAX params' keys in their
# order, then ``ops.PORT_FIELDS`` (entry ranges and the row_loop schedules
# the port's kernels read, which the JAX package keeps no copy of)
BUFFER_FIELDS = ("row_ids", "col_ids", "real_mask", "t_perm", "t_row_ids",
                 "t_col_ids", "row_perm", "inv_perm") + ops.PORT_FIELDS
# a partitioned layer's buffers: the JAX params' keys, then the per-shard
# PORT_FIELDS, each stacked [S, ...]
SHARDED_JAX_FIELDS = ("shard_src", "shard_row_ids", "shard_col_ids",
                      "shard_mask", "shard_t_perm", "shard_t_row_ids",
                      "shard_t_col_ids", "gather_rows")
SHARDED_BUFFER_FIELDS = SHARDED_JAX_FIELDS + tuple(
    "shard_" + name for name in ops.PORT_FIELDS)
# dist_spmm.ShardedArrays field -> buffer name
_SHARD_KEYS = dict(zip(("src_index", "row_ids", "col_ids", "real_mask",
                        "t_perm", "t_row_ids", "t_col_ids", "gather_rows")
                       + ops.PORT_FIELDS, SHARDED_BUFFER_FIELDS))


@dataclasses.dataclass(frozen=True)
class SparsitySpec:
    """Config for a block-sparse weight.

    The fields are the JAX package's, less ``interpret`` (a Pallas option
    with no meaning on the card).  ``backend="auto"`` routes every apply
    through ``kernels.autotune`` (the variant and N tile picked from the
    weight's structure fingerprint); ``tune_n > 0`` also runs the timed
    sweep once at ``init_sparse_linear`` with N = ``tune_n`` (the tokens a
    step feeds the layer).  ``bn`` is the JAX package's TPU tile, kept for
    config parity and not read: the kernel or the tuner picks the N tile.
    ``reorder`` applies a row scheme of ``core.permute.SCHEMES`` to the
    weight at block-row granularity (``jaccard`` | ``rcm`` |
    ``shard_balance`` | ``identity``; ``shard_balance`` balances over
    ``reorder_shards`` bins, 0 = ``launch.sharding.spmm_shard_count``);
    ``spmm`` un-permutes, so the layer's math is unchanged.

    ``shards > 0`` (or ``"auto"``) switches the layer to the partitioned
    path (``launch.dist_spmm``): the weight is split over block-rows into
    load-balanced slices with static per-shard shapes (``shard_shapes``,
    from the dims alone), each shard resolves its own kernel from its real
    structure stats, and the apply runs over the mesh installed by
    ``dist_spmm.use_spmm_mesh``, or in-process when none is (one card).
    ``shards="auto"`` resolves the count through the autotuner's shard
    axis (``resolved_shards``).  ``shard_cols`` adds the column split over
    the activation panel on a 2D mesh; ``shard_chunks`` is the column
    chunk depth of the sharded apply."""
    density: float = 0.1            # fraction of nonzero blocks
    block: Tuple[int, int] = (128, 128)
    backend: str = "nnz_stream"     # nnz_stream (alias pallas) | row_loop | xla | dense | auto
    bn: int = 512
    tune_n: int = 0
    reorder: str = "identity"
    reorder_shards: int = 0
    shards: object = 0
    shard_cols: int = 1
    shard_chunks: int = 2


def is_sharded(spec: SparsitySpec) -> bool:
    """True when the spec selects the partitioned path: an explicit shard
    count or ``"auto"`` (which may resolve to S = 1; the layer then runs
    the sharded path with one shard)."""
    return spec.shards == "auto" or \
        (isinstance(spec.shards, int) and spec.shards > 0)


def resolved_shards(spec: SparsitySpec, out_dim: int, in_dim: int,
                    max_shards: Optional[int] = None, device="cuda") -> int:
    """The spec's effective shard count for a layer of these dims.

    Explicit ``shards=N`` passes through; ``shards="auto"`` asks
    ``Autotuner.pick_shards`` on ``device`` with a DIMS-ONLY pseudo meta
    (the ``_nnzb_for`` budget, not any one layer's structure), so every
    layer sharing the spec resolves the same S.  ``max_shards`` defaults
    to ``launch.sharding.spmm_shard_count()``."""
    if not is_sharded(spec):
        return 0
    if spec.shards != "auto":
        return int(spec.shards)
    h, w = spec.block
    nbr, nbc = -(-out_dim // h), -(-in_dim // w)
    nnzb = _nnzb_for(spec, out_dim, in_dim)
    pseudo = ops.SparseMeta(
        shape=(out_dim, in_dim), block=spec.block, n_block_rows=nbr,
        n_block_cols=nbc, nnzb=nnzb, nnzb_t=nnzb, reorder=spec.reorder)
    if max_shards is None:
        from repro_torch.launch.sharding import spmm_shard_count
        max_shards = max(spmm_shard_count(), 1)
    choice = autotune.get_autotuner().pick_shards(
        pseudo, spec.tune_n or 512, max_shards=max_shards,
        n_chunks=max(spec.shard_chunks, 1), device=device)
    return choice.n_shards


def _nnzb_for(spec: SparsitySpec, out_dim: int, in_dim: int) -> int:
    h, w = spec.block
    nbr, nbc = -(-out_dim // h), -(-in_dim // w)
    nnzb = int(round(spec.density * nbr * nbc))
    nnzb = max(nnzb, max(nbr, nbc))
    # rounded up to a multiple of 16, as the JAX package does (there it lets
    # the nnz dimension shard over a mesh axis); capped for tiny matrices
    nnzb = min(-(-nnzb // 16) * 16, nbr * nbc)
    return nnzb


def _reorder_shards(spec: SparsitySpec) -> int:
    """The bin count of ``shard_balance``: the spec's, else
    ``launch.sharding.spmm_shard_count()``."""
    if spec.reorder_shards:
        return spec.reorder_shards
    from repro_torch.launch.sharding import spmm_shard_count
    return spmm_shard_count()


def shard_shapes(spec: SparsitySpec, out_dim: int, in_dim: int,
                 n_shards: Optional[int] = None, device="cuda"):
    """Dims-only per-shard static sizes: (rows_per_shard, nnzb_per_shard,
    nnzb_t_per_shard).  The entry budget is the balanced average plus 25%
    skew headroom (and a small-case floor) plus one slot per row for
    virtual-row sentinels, so layers of one spec share every buffer shape;
    ``prepare_sharded`` raises if a structure is too skewed to fit.
    ``n_shards`` overrides the spec's count."""
    h, w = spec.block
    S = n_shards if n_shards is not None \
        else resolved_shards(spec, out_dim, in_dim, device=device)
    nbr, nbc = -(-out_dim // h), -(-in_dim // w)
    nnzb = _nnzb_for(spec, out_dim, in_dim)
    rps = -(-nbr // S)
    eff = min(S, nbr)
    avg = -(-nnzb // eff)
    nnzb_ps = min(nnzb + rps, avg + max(avg // 4, 8) + rps)
    return rps, nnzb_ps, nnzb_ps + nbc


def _pattern_for(seed: int, in_dim: int, out_dim: int,
                 spec: SparsitySpec) -> bcsr_lib.BCSR:
    """THE weight pattern of ``(seed, dims, spec)`` — shared by
    ``init_sparse_linear`` and ``sparse_linear_meta``."""
    return bcsr_lib.random_bcsr_exact(
        seed, (out_dim, in_dim), spec.block,
        _nnzb_for(spec, out_dim, in_dim), dtype=np.float32)


def _sharded_kw(spec: SparsitySpec, out_dim: int, in_dim: int, device):
    """``(S, prepare_sharded keywords)`` of a partitioned layer."""
    S = resolved_shards(spec, out_dim, in_dim, device=device)
    rps, nnzb_ps, _ = shard_shapes(spec, out_dim, in_dim, n_shards=S)
    return S, dict(col_shards=spec.shard_cols, reorder=spec.reorder,
                   rows_per_shard=rps, nnzb_per_shard=nnzb_ps)


@functools.lru_cache(maxsize=None)
def sparse_linear_meta(seed: int, in_dim: int, out_dim: int,
                       spec: SparsitySpec, device="cuda"):
    """True structure meta of the layer ``init_sparse_linear(seed, ...)``
    builds (a ``ShardedMeta`` with per-shard stats when the spec is
    sharded), derived without building tensors (memoized host work).
    ``device`` only keys ``shards="auto"``."""
    a = _pattern_for(seed, in_dim, out_dim, spec)
    if is_sharded(spec):
        from repro_torch.launch import dist_spmm  # local: layering
        S, kw = _sharded_kw(spec, out_dim, in_dim, device)
        return dist_spmm.prepare_sharded_meta(a, S, **kw)
    return ops.prepare_sparse_meta(a, reorder=spec.reorder,
                                   reorder_granularity="block_row",
                                   n_shards=_reorder_shards(spec))


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


def merge_sparse_metas(metas):
    """Conservative merge of per-layer metas into one: the static fields
    must match, the stats take the max; ``ShardedMeta``s merge shard by
    shard.  Raises if the static structure differs."""
    metas = list(metas)
    if not metas:
        raise ValueError("merge_sparse_metas needs at least one meta")
    first = metas[0]
    if isinstance(first, ops.SparseMeta):
        return functools.reduce(_merge_two, metas)
    from repro_torch.launch import dist_spmm  # local: layering
    if not isinstance(first, dist_spmm.ShardedMeta):
        raise TypeError(f"unknown meta type {type(first).__name__}")
    for m in metas[1:]:
        if dataclasses.replace(m, shard_metas=()) != \
                dataclasses.replace(first, shard_metas=()):
            raise ValueError(
                "cannot merge ShardedMetas with different static structure")
    shard_metas = tuple(
        functools.reduce(_merge_two, [m.shard_metas[s] for m in metas])
        for s in range(first.n_shards))
    return dataclasses.replace(first, shard_metas=shard_metas)


def init_sparse_linear(key: int, in_dim: int, out_dim: int,
                       spec: SparsitySpec, dtype=torch.bfloat16, *,
                       device="cuda"):
    """Returns ``(params, meta)``: ``params`` a dict of tensors on
    ``device`` (``vals`` plus the index arrays of ``BUFFER_FIELDS``), and
    the static meta, equal to ``sparse_linear_meta(key, ...)``.  With
    ``spec.backend == "auto"`` and ``spec.tune_n > 0`` it also runs the
    autotuner's timed sweep for this structure on ``device`` at N =
    ``tune_n``, with the operands laid out as ``apply_sparse_linear``
    passes them (``layout="token_major"``), so ``auto`` applies hit a
    measured pick.

    With ``spec.shards`` set, ``params`` holds ``vals`` (the flat
    trainable tensor) and the row partition's ``SHARDED_BUFFER_FIELDS``
    (``launch.dist_spmm.prepare_sharded``), ``meta`` is a ``ShardedMeta``,
    and ``tune_n`` runs ``dist_spmm.tune_shards`` (per-shard picks)."""
    a = _pattern_for(key, in_dim, out_dim, spec)
    if is_sharded(spec):
        from repro_torch.launch import dist_spmm  # local: layering
        S, kw = _sharded_kw(spec, out_dim, in_dim, device)
        sharr, smeta = dist_spmm.prepare_sharded(a, S, dtype=dtype,
                                                 device=device, **kw)
        if spec.backend == "auto" and spec.tune_n > 0:
            dist_spmm.tune_shards(sharr, smeta, spec.tune_n,
                                  layout="token_major")
        return {"vals": sharr.vals,
                **{name: getattr(sharr, field)
                   for field, name in _SHARD_KEYS.items()}}, smeta
    n_shards = _reorder_shards(spec)
    # block_row granularity: the permutation relabels whole block-rows, so
    # nnzb (and every buffer's shape) is the same for every seed
    arrays, meta = ops.prepare_sparse(
        a, dtype, reorder=spec.reorder, reorder_granularity="block_row",
        n_shards=n_shards, device=device)
    if spec.backend == "auto" and spec.tune_n > 0:
        autotune.get_autotuner().tune(
            a, spec.tune_n, dtype=dtype, reorder=spec.reorder,
            reorder_granularity="block_row", n_shards=n_shards,
            layout="token_major", device=device)
    return arrays._asdict(), meta


def meta_spec(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the ``meta`` device (no
    storage), the torch counterpart of ``jax.ShapeDtypeStruct``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _port_field_specs(nbr: int, nbc: int, max_bpr: int, lead=()) -> dict:
    """Specs of ``ops.PORT_FIELDS`` for ``nbr`` block-rows, ``nbc``
    block-cols and schedules of ``max_bpr`` slots a row (``lead``: the
    shard axis of a partitioned layer)."""
    sched = nbr * max_bpr
    shapes = {"rowptr": nbr + 1, "t_rowptr": nbc + 1, "flat_idx": sched,
              "flat_col": sched, "row_len": nbr, "sddmm_flat_idx": sched}
    return {name: meta_spec((*lead, shapes[name]), torch.int32)
            for name in ops.PORT_FIELDS}


def sparse_linear_specs(in_dim: int, out_dim: int, spec: SparsitySpec,
                        dtype=torch.bfloat16, seed: Optional[int] = None,
                        device="cuda"):
    """``(params, meta)`` of the layer without building it: ``params`` maps
    every key ``init_sparse_linear`` returns to a tensor on the ``meta``
    device (shape and dtype only), ``meta`` is the static meta.

    The JAX package's keys take their shapes from the dims alone
    (``_nnzb_for``; a partitioned spec's from ``shard_shapes``), so they
    are the same for every seed.  ``seed`` controls the meta: with the
    layer's init seed it is the TRUE structure meta (``sparse_linear_meta``,
    equal to what ``init_sparse_linear(seed, ...)`` returns); with None it
    is dims-only, its stats 0 (``auto`` then resolves to the streamed
    kernel and ``row_loop`` raises).  The port's own schedule buffers
    (``ops.PORT_FIELDS``) are sized by that meta's ``max_bpr``, so with the
    layer's seed every shape equals ``init_sparse_linear``'s.  ``device``
    only keys ``shards="auto"``'s resolution."""
    h, w = spec.block
    nnzb = _nnzb_for(spec, out_dim, in_dim)
    nbr, nbc = -(-out_dim // h), -(-in_dim // w)
    i32 = torch.int32
    if is_sharded(spec):
        from repro_torch.launch import dist_spmm  # local: layering
        S = resolved_shards(spec, out_dim, in_dim, device=device)
        rps, nnzb_ps, nnzb_t_ps = shard_shapes(spec, out_dim, in_dim,
                                               n_shards=S)
        if seed is not None:
            meta = sparse_linear_meta(seed, in_dim, out_dim, spec,
                                      device=device)
        else:
            shard_meta = ops.SparseMeta(
                shape=(rps * h, in_dim), block=spec.block,
                n_block_rows=rps, n_block_cols=nbc, nnzb=nnzb_ps,
                nnzb_t=nnzb_t_ps, reorder="identity", n_shards=S)
            meta = dist_spmm.ShardedMeta(
                shape=(out_dim, in_dim), block=spec.block, n_shards=S,
                col_shards=spec.shard_cols, rows_per_shard=rps, nnzb=nnzb,
                nnzb_per_shard=nnzb_ps, nnzb_t_per_shard=nnzb_t_ps,
                shard_metas=(shard_meta,) * S, reorder=spec.reorder)
        # dist_spmm.shard_port_fields: schedules at the shards' largest
        # max_bpr, at least 1
        max_bpr = max([m.max_bpr for m in meta.shard_metas] + [1])
        port = _port_field_specs(rps, nbc, max_bpr, lead=(S,))
        params = {
            "vals": meta_spec((nnzb, h, w), dtype),
            "shard_src": meta_spec((S, nnzb_ps), i32),
            "shard_row_ids": meta_spec((S, nnzb_ps), i32),
            "shard_col_ids": meta_spec((S, nnzb_ps), i32),
            "shard_mask": meta_spec((S, nnzb_ps), torch.bool),
            "shard_t_perm": meta_spec((S, nnzb_t_ps), i32),
            "shard_t_row_ids": meta_spec((S, nnzb_t_ps), i32),
            "shard_t_col_ids": meta_spec((S, nnzb_t_ps), i32),
            "gather_rows": meta_spec((out_dim,), i32),
            **{"shard_" + name: t for name, t in port.items()}}
        return params, meta
    if seed is not None:
        meta = sparse_linear_meta(seed, in_dim, out_dim, spec, device=device)
    else:
        meta = ops.SparseMeta(shape=(out_dim, in_dim), block=spec.block,
                              n_block_rows=nbr, n_block_cols=nbc,
                              nnzb=nnzb, nnzb_t=nnzb, reorder=spec.reorder)
    params = {
        "vals": meta_spec((nnzb, h, w), dtype),
        **{name: meta_spec((nnzb,), torch.bool if name == "real_mask" else i32)
           for name in ("row_ids", "col_ids", "real_mask", "t_perm",
                        "t_row_ids", "t_col_ids")},
        "row_perm": meta_spec((out_dim,), i32),
        "inv_perm": meta_spec((out_dim,), i32),
        **_port_field_specs(nbr, nbc, meta.max_bpr)}
    return params, meta


def shard_balance_report(in_dim: int, out_dim: int, spec: SparsitySpec,
                         seed: int = 7919, device="cuda") -> dict:
    """Per-shard nnzb balance of the layer this spec and seed build (host
    only: the dry-run prints it, so the partition's quality shows before
    any launch).  ``device`` only keys ``shards="auto"``."""
    from repro_torch.launch import dist_spmm  # local: layering
    a = _pattern_for(seed, in_dim, out_dim, spec)
    S = resolved_shards(spec, out_dim, in_dim, device=device)
    rps, _, _ = shard_shapes(spec, out_dim, in_dim, n_shards=S)
    return dist_spmm.shard_balance_stats(a, S, rows_per_shard=rps)


def sparse_param_flops(meta) -> int:
    """Operations per token of the layer (2 * nnzb * h * w, over its stored
    blocks): the roofline's work count for sparse weights."""
    h, w = meta.block
    return 2 * meta.nnzb * h * w


def apply_sparse_linear(params, meta, x: torch.Tensor,
                        spec: SparsitySpec) -> torch.Tensor:
    """y[..., out] = x[..., in] @ W^T via C = W @ x^T.  ``params`` is a
    mapping with the keys ``init_sparse_linear`` returns (or a
    ``SparseLinear``, whose ``params()`` gives one).  The kernel reads the
    transposed view x^T as it is, with no copy.

    Sharded (``meta`` a ``ShardedMeta``): each shard streams its balanced
    slice, over the mesh ``dist_spmm.use_spmm_mesh`` installed or
    in-process when none is, with the panel in ``spec.shard_chunks``
    column chunks (``dist_spmm.spmm_sharded``).  The ``constrain`` calls
    stand where the JAX package's do and return their input: under a
    training mesh whose compute splits over ``model``
    (``launch.steps.split_leaves``) ``x`` already holds this rank's tokens
    (the sequence-split carry), so B1 forward, B1 dB and B2 dvals run on
    them against the replicated weights, with no collective here."""
    lead = x.shape[:-1]
    xt = x.reshape(-1, x.shape[-1]).T                # [K, T]
    if is_sharded(spec):
        from repro_torch.launch import dist_spmm  # local: layering
        sharr = dist_spmm.ShardedArrays(
            vals=params["vals"],
            **{field: params[name] for field, name in _SHARD_KEYS.items()})
        mesh = dist_spmm.current_spmm_mesh()
        if mesh is None:
            xt = constrain(xt, None, BATCH + (MODEL,))
        c = dist_spmm.spmm_sharded(sharr, meta, xt, backend=spec.backend,
                                   mesh=mesh,
                                   n_chunks=max(spec.shard_chunks, 1))
        if mesh is None:
            c = constrain(c, None, BATCH + (MODEL,))
        return c.T.reshape(*lead, meta.shape[0])
    arrays = ops.SparseArrays(
        vals=params["vals"], row_ids=params["row_ids"],
        col_ids=params["col_ids"], real_mask=params["real_mask"],
        t_perm=params["t_perm"], t_row_ids=params["t_row_ids"],
        t_col_ids=params["t_col_ids"], row_perm=params.get("row_perm"),
        inv_perm=params.get("inv_perm"),
        **{name: params.get(name) for name in ops.PORT_FIELDS})
    xt = constrain(xt, None, BATCH + (MODEL,))       # tokens over all axes
    c = ops.spmm(arrays, meta, xt, backend=spec.backend)   # [M, T]
    c = constrain(c, None, BATCH + (MODEL,))
    return c.T.reshape(*lead, meta.shape[0])


class SparseLinear(nn.Module):
    """A block-sparse linear layer: ``vals`` is its parameter (trained
    through the sparse product's backward), the index arrays are buffers
    (``BUFFER_FIELDS``, or ``SHARDED_BUFFER_FIELDS`` for a partitioned
    spec), ``meta`` and ``spec`` are static."""

    def __init__(self, params, meta, spec: SparsitySpec):
        super().__init__()
        self.meta, self.spec = meta, spec
        self.buffer_fields = SHARDED_BUFFER_FIELDS if is_sharded(spec) \
            else BUFFER_FIELDS
        self.vals = nn.Parameter(params["vals"])
        for name in self.buffer_fields:
            self.register_buffer(name, params[name])

    def params(self) -> dict:
        return {"vals": self.vals,
                **{name: getattr(self, name) for name in self.buffer_fields}}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_sparse_linear(self.params(), self.meta, x, self.spec)
