"""Sharded SpMM execution: row-partitioned BCSR over a mesh of ranks.

The twin of the JAX package's ``launch/dist_spmm.py``:

  * ``prepare_sharded`` partitions a host BCSR over block-rows with the
    capacitated LPT bin assignment (``core.permute.shard_bins``): every
    shard owns exactly ``rows_per_shard`` block-row slots (trailing slots
    virtual) and a fixed ``nnzb_per_shard`` entry budget, so per-shard
    shapes never depend on which shard a block landed in.  Its host data is
    the JAX package's, element for element.
  * ``spmm_sharded`` runs the partition in-process (``mesh=None``: every
    shard in ascending order, on this device; one card runs this mode) or
    over a ``torch.distributed`` mesh with an ``"spmm"`` axis (each rank
    runs its own shard, and an ``"spmm_col"`` axis splits B's columns).
    Each shard resolves its OWN kernel (``ops.resolve_backend`` on its
    per-shard ``SparseMeta``) and runs it through ``ops``' CUDA kernels:
    B1 or B3 forward, B1 over the transpose structure for dB, B2 or B4 for
    dvals.
  * ``n_chunks > 1`` runs the panel in ascending column chunks.  Eager
    PyTorch issues work in program order, so the JAX package's
    ``optimization_barrier`` staging has no counterpart here: a chunk is a
    column view of B.  Kernel picks (and the N tile) are resolved at the
    FULL panel width, so the chunked result equals the unchunked one bit
    for bit wherever the kernel's launch configuration is the same at both
    widths (``bcsr_spmm.spmm_launch_config``: its row block switches at 16
    columns; the chunks of N = 4 and of N >= 64 stay on one side).  The
    backward runs the unchunked per-shard products whatever ``n_chunks``.
  * Shard count is an autotune axis: ``prepare_sharded(a, "auto")``
    resolves S through ``Autotuner.pick_shards``; ``tune_shard_count``
    times the S candidates.
  * ``split_heavy_rows=True`` splits a block-row heavier than the balanced
    budget into entry fragments; their partial sums are added back in
    ascending fragment order.
  * Results come back in ORIGINAL row order (``gather_rows`` composes the
    optional pre-reorder with the partition).

Gradients: ``_SpmmSharded`` holds the whole sharded product as one
autograd ``Function``.  Its backward computes, per shard, dB through the
transpose structure and dvals through the SDDMM kernel, on the unchunked
panel, and never re-runs a forward product.  dB sums the shards' partials
in ascending shard order in float32; dvals scatter into the flat ``vals``
gradient (each real entry lives in exactly one shard slot, so the scatter
is exact).  In mesh mode every rank gathers every partial and sums them in
the same order, so with ``col_shards == 1`` the mesh gradients equal the
in-process ones bit for bit; with a column split the dvals partials of a
shard's column blocks are summed too (not bitwise, within f32 rounding).
First derivatives only (the backward is ``once_differentiable``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable
from torch.nn import functional as F

from repro_torch.core import bcsr as bcsr_lib
from repro_torch.core import permute as permute_lib
from repro_torch.kernels import bcsr_spmm as pk
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

AXIS_ROW = "spmm"        # mesh axis the block-row partition maps onto
AXIS_COL = "spmm_col"    # optional 2D axis: column split over B


# ---------------------------------------------------------------------- types
class ShardedArrays(NamedTuple):
    """Tensors of a row-partitioned BCSR operand.

    ``vals`` stays the FLAT global entry list, the single trainable tensor,
    shaped like the unsharded operand's.  The per-shard fields are index
    structure only (leading axis = shard), equal to the JAX package's:

      src_index  [S, nnzb_ps]    entry index into vals (nnzb = zero sentinel)
      row_ids    [S, nnzb_ps]    LOCAL block-row ids, sorted row-major
      col_ids    [S, nnzb_ps]    global block-col ids
      real_mask  [S, nnzb_ps]    False for sentinel/padding entries
      t_perm     [S, nnzb_t_ps]  local transpose gather (nnzb_ps = sentinel)
      t_row_ids  [S, nnzb_t_ps]  block-rows of the local A^T (= global bcols)
      t_col_ids  [S, nnzb_t_ps]  LOCAL block-rows of A
      gather_rows [M]            original row -> row of the stacked shard
                                 outputs
      split_src   [n_extra]      stacked-output rows of non-primary row
                                 fragments (empty without splits)
      split_dst   [n_extra]      original rows those partial sums add into

    Then the port's own, per shard (``ops.PORT_FIELDS``, built on the host
    by ``ops.port_fields`` from each shard's entry list): ``rowptr`` [S,
    rps + 1] and ``t_rowptr`` [S, nbc + 1], the entry ranges the streamed
    kernel reads, and the ``row_loop`` schedules ``flat_idx``,
    ``flat_col``, ``sddmm_flat_idx`` [S, rps * max_bpr] and ``row_len``
    [S, rps], all at the largest ``max_bpr`` of the shards (a schedule
    longer than a shard needs runs the same products: the kernels read a
    row's live slots only).  One stacked schedule so covers every shard,
    whichever kernel it picks; the JAX package instead builds each
    ``lax.switch`` branch's schedule at its members' largest ``max_bpr``
    (``_branch_meta``)."""
    vals: torch.Tensor
    src_index: torch.Tensor
    row_ids: torch.Tensor
    col_ids: torch.Tensor
    real_mask: torch.Tensor
    t_perm: torch.Tensor
    t_row_ids: torch.Tensor
    t_col_ids: torch.Tensor
    gather_rows: torch.Tensor
    split_src: Optional[torch.Tensor] = None
    split_dst: Optional[torch.Tensor] = None
    rowptr: Optional[torch.Tensor] = None
    t_rowptr: Optional[torch.Tensor] = None
    flat_idx: Optional[torch.Tensor] = None
    flat_col: Optional[torch.Tensor] = None
    row_len: Optional[torch.Tensor] = None
    sddmm_flat_idx: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class ShardedMeta:
    """Static (hashable) metadata of a sharded operand.

    ``shard_metas[s]`` is a full per-shard ``SparseMeta`` (shape
    ``(rows_per_shard*h, K)``, ``nnzb = nnzb_per_shard``, its own
    max_bpr/padding/skew stats, ``n_shards`` set): the fingerprint the
    autotuner picks each shard's kernel from."""
    shape: Tuple[int, int]              # logical global (M, K)
    block: Tuple[int, int]
    n_shards: int
    col_shards: int
    rows_per_shard: int                 # block-row slots per shard
    nnzb: int                           # global flat entry count (vals)
    nnzb_per_shard: int
    nnzb_t_per_shard: int
    shard_metas: Tuple[ops.SparseMeta, ...]
    reorder: str = "identity"           # pre-partition scheme (reporting)
    n_split_fragments: int = 0          # extra (non-primary) row fragments


# ------------------------------------------------------------- ambient mesh
_MESH_STACK: list = [None]


@contextlib.contextmanager
def use_spmm_mesh(mesh):
    """Route ``apply_sparse_linear``'s sharded path (and the sharded
    attention context) through ``mesh`` for the duration.  ``mesh=None``
    is a no-op passthrough."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def current_spmm_mesh():
    return _MESH_STACK[-1]


def make_spmm_mesh(n_shards: int, col_shards: int = 1,
                   device_type: str = "cuda"):
    """Dedicated (n_shards,) or (n_shards, col_shards) mesh over the
    initialised world, axes ``(AXIS_ROW[, AXIS_COL])``: one rank a shard
    (and column block).  ``device_type="cpu"`` builds one over ``gloo``
    ranks."""
    mesh_lib.check_device_type(device_type)
    need = n_shards * col_shards
    have = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 0
    if have != need:
        raise ValueError(
            f"spmm mesh needs {need} ranks, the world has {have} (start "
            f"{need} processes and call torch.distributed."
            "init_process_group in each)")
    if col_shards > 1:
        return mesh_lib.make_mesh((n_shards, col_shards),
                                  (AXIS_ROW, AXIS_COL), device_type)
    return mesh_lib.make_mesh((n_shards,), (AXIS_ROW,), device_type)


# ----------------------------------------------------------------- chunking
def chunk_schedule(n: int, n_chunks: int) -> Tuple[Tuple[int, int], ...]:
    """Ascending ``(start, stop)`` column chunks that partition ``[0, n)``:
    contiguous, non-empty, each column once; ``n_chunks`` is clamped to
    ``n``.

    >>> chunk_schedule(10, 4)
    ((0, 3), (3, 6), (6, 9), (9, 10))
    >>> chunk_schedule(8, 1)
    ((0, 8),)
    """
    if n < 1:
        raise ValueError(f"panel width must be >= 1, got {n}")
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    k = min(int(n_chunks), int(n))
    width = -(-n // k)
    bounds = []
    start = 0
    while start < n:
        stop = min(start + width, n)
        bounds.append((start, stop))
        start = stop
    return tuple(bounds)


def _run_chunked(run_one, b: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """``run_one`` over ascending column views of ``b``, the panels
    concatenated in that order."""
    bounds = chunk_schedule(int(b.shape[-1]), n_chunks)
    if len(bounds) == 1:
        return run_one(b)
    return torch.cat([run_one(b[:, lo:hi]) for lo, hi in bounds], dim=1)


# ----------------------------------------------------------------- planning
def plan_shards(a_p: bcsr_lib.BCSR, n_shards: int, *,
                rows_per_shard: Optional[int] = None,
                nnzb_per_shard: Optional[int] = None):
    """Balanced block-row partition of a (row-padded) BCSR.

    Returns ``(assign, shard_rows, loads, rps)``: the LPT bin assignment
    (``core.permute.shard_bins``), per-shard sorted block-row lists, the
    per-shard nonzero-block loads, and the (resolved) row-slot count."""
    nbr = a_p.n_block_rows
    rps = rows_per_shard or -(-max(nbr, 1) // n_shards)
    bpr = np.diff(a_p.rowptr)
    max_load = nnzb_per_shard
    if max_load is not None:
        # every virtual row slot costs one sentinel entry on whichever shard
        # it lands: reserve the worst case so the LPT never fills headroom
        # the sentinels need
        v_max = min(max(n_shards * rps - nbr, 0), rps)
        max_load = max_load - v_max
    assign = permute_lib.shard_bins(
        bpr, n_shards, rows_per_shard=rps, max_load=max_load)
    shard_rows = [np.flatnonzero(assign == s) for s in range(n_shards)]
    loads = np.asarray([int(bpr[r].sum()) for r in shard_rows], np.int64)
    return assign, shard_rows, loads, rps


def _local_stats(rows: np.ndarray, vals_real: np.ndarray, rps: int,
                 nnzb_ps: int, block) -> Tuple[int, int, int]:
    """(max_bpr, pad_pct, cv_pct) of one shard's padded local structure."""
    h, w = block
    bpr = np.bincount(rows, minlength=rps).astype(np.float64)
    mean = float(bpr.mean()) if bpr.size else 0.0
    cv = float(bpr.std() / mean) if mean > 0 else 0.0
    nnz = int(np.count_nonzero(vals_real))
    pad = 1.0 - nnz / max(nnzb_ps * h * w, 1)
    return (int(bpr.max()) if bpr.size else 0, int(round(pad * 100)),
            int(round(cv * 100)))


@obs_trace.spanned("prepare.shard")
def _prepare_sharded_host(a: bcsr_lib.BCSR, n_shards, *,
                          col_shards: int = 1,
                          reorder: str = "identity", tau: float = 0.7,
                          max_candidates: Optional[int] = None,
                          rows_per_shard: Optional[int] = None,
                          nnzb_per_shard: Optional[int] = None,
                          split_heavy_rows: bool = False,
                          device="cuda"):
    """Host-side (numpy) portion of ``prepare_sharded``: pre-reorder,
    partition, per-shard index structure and the static ``ShardedMeta``.
    Returns ``(host_arrays_dict, meta)``.  ``n_shards="auto"`` resolves the
    count through :func:`resolve_n_shards` for ``device``."""
    if isinstance(n_shards, str):
        if n_shards != "auto":
            raise ValueError(f"n_shards must be an int or 'auto', "
                             f"got {n_shards!r}")
        n_shards = resolve_n_shards(a, device=device).n_shards
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    h, w = a.block
    M, K = a.shape
    pre_perm = np.arange(M, dtype=np.int64)
    if reorder not in ("identity", "shard_balance"):
        with obs_trace.span("prepare.shard.reorder", scheme=reorder):
            a, pre_perm = permute_lib.permute_bcsr(
                a, reorder, tau=tau, max_candidates=max_candidates,
                n_shards=n_shards, granularity="block_row")
    a_p, real_g = a.ensure_nonempty_rows(return_mask=True)
    nbr, nbc = a_p.n_block_rows, a_p.n_block_cols
    rowptr = a_p.rowptr
    bpr = np.diff(rowptr)
    nnzb_g = a_p.nnzb

    if split_heavy_rows:
        if nnzb_per_shard is not None:
            raise ValueError(
                "split_heavy_rows derives its own per-shard budget from "
                "the balanced load; pinning nnzb_per_shard alongside it "
                "is contradictory — drop one of the two")
        # heavy rows split into contiguous entry runs no larger than the
        # balanced per-shard load; the SAME LPT places fragments into row
        # slots (a fragment is a local row)
        cap = max(-(-nnzb_g // n_shards), 1)
        frag_row, frag_start, frag_len = permute_lib.split_heavy_rows(
            bpr, cap)
        n_frags = int(frag_row.size)
        rps = rows_per_shard or -(-max(n_frags, 1) // n_shards)
        if rps * n_shards < n_frags:
            raise ValueError(
                f"rows_per_shard={rps} too small for {n_frags} row "
                f"fragments over {n_shards} shards")
        assign = permute_lib.shard_bins(frag_len, n_shards,
                                        rows_per_shard=rps)
        shard_units = [np.flatnonzero(assign == s) for s in range(n_shards)]
        shard_loads = np.asarray([int(frag_len[u].sum())
                                  for u in shard_units], np.int64)
        unit_row, unit_start, unit_len = frag_row, frag_start, frag_len
    else:
        assign, shard_units, shard_loads, rps = plan_shards(
            a_p, n_shards, rows_per_shard=rows_per_shard,
            nnzb_per_shard=nnzb_per_shard)
        if rps * n_shards < nbr:
            raise ValueError(f"rows_per_shard={rps} too small for {nbr} "
                             f"block-rows over {n_shards} shards")
        unit_row = np.arange(nbr, dtype=np.int64)
        unit_start = np.zeros(nbr, np.int64)
        unit_len = bpr.astype(np.int64)

    # per-shard balance record: the LPT's real loads, before padding
    mean_load = float(shard_loads.mean()) if shard_loads.size else 0.0
    imbalance = (round(float(shard_loads.max()) / mean_load, 3)
                 if mean_load > 0 else 1.0)
    obs_trace.event("dist.shard_balance", n_shards=n_shards,
                    loads=shard_loads, imbalance=imbalance,
                    split_heavy_rows=bool(split_heavy_rows))
    obs_metrics.gauge("dist.shard_imbalance", n_shards=n_shards).set(
        imbalance)

    # per-shard entry lists (entries stay in a_p's global order; local ids
    # relabel planning units to each shard's slot space)
    needed = []
    per_shard = []
    for s in range(n_shards):
        units_s = shard_units[s]
        ent = np.concatenate(
            [rowptr[unit_row[u]] + unit_start[u] +
             np.arange(unit_len[u]) for u in units_s]
        ).astype(np.int64) if units_s.size else np.zeros(0, np.int64)
        lrow = np.repeat(np.arange(units_s.size),
                         unit_len[units_s]) if units_s.size \
            else np.zeros(0, np.int64)
        n_virtual = rps - units_s.size
        needed.append(ent.size + n_virtual)
        per_shard.append((units_s, ent, lrow, n_virtual))
    nnzb_ps = nnzb_per_shard or max(needed)
    if (nnzb_per_shard is None and not split_heavy_rows and n_shards > 1):
        # the derived budget is only honest when the heaviest block-row
        # fits a balanced shard: refuse, and point at the split path
        bal = -(-nnzb_g // n_shards) + rps
        if nnzb_ps > 2 * bal and int(bpr.max(initial=0)) > bal:
            raise ValueError(
                f"heaviest block-row ({int(bpr.max())} blocks) exceeds "
                f"the balanced per-shard budget ({bal}); the derived "
                f"budget {nnzb_ps} would over-allocate every shard — "
                "pass split_heavy_rows=True (entry-granular splits) or "
                "pin nnzb_per_shard explicitly")
    too_big = [s for s in range(n_shards) if needed[s] > nnzb_ps]
    if too_big:
        raise ValueError(
            f"shard(s) {too_big} need {[needed[s] for s in too_big]} entry "
            f"slots but the per-shard budget is {nnzb_ps}; raise "
            f"nnzb_per_shard or lower n_shards")
    nnzb_t_ps = nnzb_ps + nbc
    sentinel = nnzb_g            # extra zero block appended to vals at apply

    src = np.full((n_shards, nnzb_ps), sentinel, np.int32)
    rows = np.zeros((n_shards, nnzb_ps), np.int32)
    cols = np.zeros((n_shards, nnzb_ps), np.int32)
    mask = np.zeros((n_shards, nnzb_ps), bool)
    t_perm = np.zeros((n_shards, nnzb_t_ps), np.int32)
    t_rows = np.zeros((n_shards, nnzb_t_ps), np.int32)
    t_cols = np.zeros((n_shards, nnzb_t_ps), np.int32)
    metas = []
    for s, (units_s, ent, lrow, n_virtual) in enumerate(per_shard):
        n_real = ent.size
        # one sentinel per virtual row keeps every block-row nonempty;
        # leftover budget pads row 0
        vrows = np.arange(units_s.size, rps)
        l_rows = np.concatenate([
            lrow, vrows, np.zeros(nnzb_ps - n_real - n_virtual, np.int64)])
        l_cols = np.concatenate([
            a_p.col_ids[ent].astype(np.int64),
            np.zeros(nnzb_ps - n_real, np.int64)])
        l_src = np.concatenate([
            ent, np.full(nnzb_ps - n_real, sentinel, np.int64)])
        l_mask = np.concatenate([
            real_g[ent], np.zeros(nnzb_ps - n_real, bool)])
        order = np.lexsort((l_cols, l_rows))
        rows[s] = l_rows[order]
        cols[s] = l_cols[order]
        src[s] = l_src[order]
        mask[s] = l_mask[order]
        # transpose structure: every local slot + one t-sentinel per
        # t-block-row for full coverage (nnzb_ps + nbc entries)
        tt_rows = np.concatenate([cols[s].astype(np.int64),
                                  np.arange(nbc, dtype=np.int64)])
        tt_cols = np.concatenate([rows[s].astype(np.int64),
                                  np.zeros(nbc, np.int64)])
        tt_perm = np.concatenate([np.arange(nnzb_ps, dtype=np.int64),
                                  np.full(nbc, nnzb_ps, np.int64)])
        t_order = np.lexsort((tt_cols, tt_rows))
        t_rows[s] = tt_rows[t_order]
        t_cols[s] = tt_cols[t_order]
        t_perm[s] = tt_perm[t_order]
        max_bpr, pad_pct, cv_pct = _local_stats(
            rows[s], a_p.vals[ent], rps, nnzb_ps, (h, w))
        metas.append(ops.SparseMeta(
            shape=(rps * h, K), block=(h, w), n_block_rows=rps,
            n_block_cols=nbc, nnzb=nnzb_ps, nnzb_t=nnzb_t_ps,
            max_bpr=max_bpr, padding_ratio_pct=pad_pct, bpr_cv_pct=cv_pct,
            reorder="identity", n_shards=n_shards))

    # original row -> stacked output row: pre-reorder, then partition slot.
    # A split block-row's PRIMARY fragment (entry offset 0) carries the row
    # through the gather; the extras add back via split_src/split_dst.
    inv_pre = permute_lib.invert_perm(pre_perm)
    slot_of_unit = np.empty(max(unit_row.size, 1), np.int64)
    for s in range(n_shards):
        us = shard_units[s]
        slot_of_unit[us] = s * rps + np.arange(us.size)
    primary = unit_start == 0
    slot_of_br = np.empty(nbr, np.int64)
    slot_of_br[unit_row[primary]] = slot_of_unit[: unit_row.size][primary]
    perm_rows = inv_pre                       # position after pre-reorder
    gather = slot_of_br[perm_rows // h] * h + perm_rows % h

    extra = np.flatnonzero(~primary)
    ar = np.arange(h, dtype=np.int64)
    x_rows = (unit_row[extra][:, None] * h + ar).ravel()    # a_p row space
    s_rows = (slot_of_unit[extra][:, None] * h + ar).ravel()
    valid = x_rows < M          # last block-row's pad rows carry no data
    split_src = s_rows[valid].astype(np.int64)
    split_dst = pre_perm[x_rows[valid]].astype(np.int64)

    host = {
        "vals": a_p.vals,
        "src_index": src,
        "row_ids": rows,
        "col_ids": cols,
        "real_mask": mask,
        "t_perm": t_perm,
        "t_row_ids": t_rows,
        "t_col_ids": t_cols,
        "gather_rows": gather,
        "split_src": split_src,
        "split_dst": split_dst,
    }
    meta = ShardedMeta(shape=(M, K), block=(h, w), n_shards=n_shards,
                       col_shards=col_shards, rows_per_shard=rps,
                       nnzb=nnzb_g, nnzb_per_shard=nnzb_ps,
                       nnzb_t_per_shard=nnzb_t_ps, shard_metas=tuple(metas),
                       reorder=reorder,
                       n_split_fragments=int(extra.size))
    return host, meta


def shard_port_fields(row_ids: np.ndarray, col_ids: np.ndarray,
                      t_row_ids: np.ndarray, meta: ShardedMeta) -> dict:
    """The per-shard ``ops.PORT_FIELDS`` of a partition, stacked ``[S,
    ...]``: ``ops.port_fields`` of each shard's entry list (``row_ids[s]``,
    ``col_ids[s]``, ``t_row_ids[s]``), the schedules at the largest
    ``max_bpr`` of ``meta.shard_metas`` so every shard's has one length."""
    max_bpr = max([m.max_bpr for m in meta.shard_metas] + [1])
    per = [ops.port_fields(np.asarray(row_ids[s]), np.asarray(col_ids[s]),
                           np.asarray(t_row_ids[s]), meta.rows_per_shard,
                           meta.shard_metas[s].n_block_cols, max_bpr)
           for s in range(meta.n_shards)]
    return {name: np.stack([p[name] for p in per]).astype(np.int32)
            for name in ops.PORT_FIELDS}


def resolve_n_shards(a: bcsr_lib.BCSR, *, n: int = 512, max_shards: int = 8,
                     n_chunks: int = 2, tuner=None, device="cuda"):
    """Resolve ``n_shards="auto"`` for a host BCSR: the autotuner's
    shard-count pick (``Autotuner.pick_shards``: a cached entry for this
    structure on ``device``, else the analytic model over {1, 2, 4, 8}
    capped at ``max_shards``) on the operand's unsharded meta.  Returns the
    ``ShardChoice``."""
    from repro_torch.kernels import autotune  # local: autotune imports ops
    meta = ops.prepare_sparse_meta(a)
    t = tuner if tuner is not None else autotune.get_autotuner()
    return t.pick_shards(meta, n, max_shards=max_shards, n_chunks=n_chunks,
                         device=device)


def prepare_sharded(a: bcsr_lib.BCSR, n_shards, *,
                    col_shards: int = 1, dtype=torch.bfloat16,
                    reorder: str = "identity", tau: float = 0.7,
                    max_candidates: Optional[int] = None,
                    rows_per_shard: Optional[int] = None,
                    nnzb_per_shard: Optional[int] = None,
                    split_heavy_rows: bool = False,
                    device="cuda") -> Tuple[ShardedArrays, ShardedMeta]:
    """Host BCSR -> row-partitioned tensors on ``device`` + static meta.

    ``n_shards`` is an int, or ``"auto"`` (:func:`resolve_n_shards`).
    ``reorder`` applies ``jaccard`` | ``rcm`` first; ``"shard_balance"``
    and ``"identity"`` skip the pre-permutation (the partition itself is
    the balance).  ``rows_per_shard`` / ``nnzb_per_shard`` pin the
    per-shard shapes (the model-weight path derives them from dims);
    omitted, they fit the structure.  Raises when the structure cannot
    fit.  ``split_heavy_rows=True`` splits block-rows heavier than the
    balanced budget into entry fragments.

    >>> import torch
    >>> from repro_torch.core import bcsr as bcsr_lib
    >>> from repro_torch.launch import dist_spmm
    >>> a = bcsr_lib.random_bcsr_exact(7, (320, 256), (16, 16), nnzb=80)
    >>> sharr, smeta = dist_spmm.prepare_sharded(a, 4, dtype=torch.float32,
    ...                                          device="cpu")
    >>> (smeta.n_shards, smeta.rows_per_shard, len(smeta.shard_metas))
    (4, 5, 4)
    >>> all(m.max_bpr > 0 for m in smeta.shard_metas)
    True
    """
    host, meta = _prepare_sharded_host(
        a, n_shards, col_shards=col_shards, reorder=reorder, tau=tau,
        max_candidates=max_candidates, rows_per_shard=rows_per_shard,
        nnzb_per_shard=nnzb_per_shard, split_heavy_rows=split_heavy_rows,
        device=device)
    return sharded_tensors(host, meta, dtype, device), meta


def sharded_tensors(host: dict, meta: ShardedMeta, dtype,
                    device) -> ShardedArrays:
    """``ShardedArrays`` on ``device`` from ``_prepare_sharded_host``'s
    host dict, the per-shard port fields included."""
    def dev(x, dt=torch.int32):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

    port = shard_port_fields(host["row_ids"], host["col_ids"],
                             host["t_row_ids"], meta)
    return ShardedArrays(
        vals=dev(host["vals"], dtype),
        src_index=dev(host["src_index"]),
        row_ids=dev(host["row_ids"]),
        col_ids=dev(host["col_ids"]),
        real_mask=dev(host["real_mask"], torch.bool),
        t_perm=dev(host["t_perm"]),
        t_row_ids=dev(host["t_row_ids"]),
        t_col_ids=dev(host["t_col_ids"]),
        gather_rows=dev(host["gather_rows"]),
        split_src=dev(host["split_src"]),
        split_dst=dev(host["split_dst"]),
        **{name: dev(port[name]) for name in ops.PORT_FIELDS})


def prepare_sharded_meta(a: bcsr_lib.BCSR, n_shards, *,
                         col_shards: int = 1, reorder: str = "identity",
                         tau: float = 0.7,
                         max_candidates: Optional[int] = None,
                         rows_per_shard: Optional[int] = None,
                         nnzb_per_shard: Optional[int] = None,
                         split_heavy_rows: bool = False,
                         device="cuda") -> ShardedMeta:
    """The ``ShardedMeta`` that ``prepare_sharded`` would return, without
    building tensors (the same host pipeline).  ``device`` only keys an
    ``"auto"`` shard count."""
    return _prepare_sharded_host(
        a, n_shards, col_shards=col_shards, reorder=reorder, tau=tau,
        max_candidates=max_candidates, rows_per_shard=rows_per_shard,
        nnzb_per_shard=nnzb_per_shard, split_heavy_rows=split_heavy_rows,
        device=device)[1]


def prepare(a: bcsr_lib.BCSR, n_shards, *, meta_only: bool = False,
            col_shards: int = 1, dtype=torch.bfloat16,
            reorder: str = "identity", tau: float = 0.7,
            max_candidates: Optional[int] = None,
            rows_per_shard: Optional[int] = None,
            nnzb_per_shard: Optional[int] = None,
            split_heavy_rows: bool = False, device="cuda"):
    """``(ShardedArrays, ShardedMeta)`` through :func:`prepare_sharded`, or
    the ``ShardedMeta`` alone with ``meta_only=True``.

    >>> from repro_torch.core import bcsr as bcsr_lib
    >>> from repro_torch.launch import dist_spmm
    >>> a = bcsr_lib.random_bcsr_exact(7, (320, 256), (16, 16), nnzb=80)
    >>> _, smeta = dist_spmm.prepare(a, 4, device="cpu")
    >>> dist_spmm.prepare(a, 4, meta_only=True) == smeta
    True
    """
    kw = dict(col_shards=col_shards, reorder=reorder, tau=tau,
              max_candidates=max_candidates, rows_per_shard=rows_per_shard,
              nnzb_per_shard=nnzb_per_shard, split_heavy_rows=split_heavy_rows,
              device=device)
    if meta_only:
        return prepare_sharded_meta(a, n_shards, **kw)
    return prepare_sharded(a, n_shards, dtype=dtype, **kw)


# ---------------------------------------------------------------- execution
def _combine_splits(out: torch.Tensor, out_pad: torch.Tensor,
                    arrays: ShardedArrays) -> torch.Tensor:
    """Add non-primary row-fragment partial sums back into their original
    rows, in ascending fragment order: a row split in k fragments repeats
    its rows k - 1 times in ``split_dst``, and ``index_add_`` sums repeated
    indices in no fixed order on the card, so each pass adds the next
    fragment of every split row (indices unique within a pass).  Returns
    ``out`` itself when the operand has no split."""
    src = arrays.split_src
    if src is None or int(src.shape[0]) == 0:
        return out
    dst = arrays.split_dst.long()
    order = torch.argsort(dst, stable=True)
    sd = dst[order]
    first = torch.ones_like(sd, dtype=torch.bool)
    first[1:] = sd[1:] != sd[:-1]
    pos = torch.arange(sd.numel(), device=sd.device)
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start            # 0 for a row's first extra, ...
    out = out.clone()
    parts = out_pad.index_select(0, src.long())
    for p in range(int(rank.max()) + 1):
        sel = torch.nonzero(rank == p).flatten()
        out.index_add_(0, dst[sel], parts[sel])
    return out


def _resolve_shard_choices(smeta: ShardedMeta, n_local: int, backend: str,
                           bn: Optional[int], device="cuda"
                           ) -> Tuple[Tuple[str, Optional[int]], ...]:
    """Per-shard (backend, bn): ``auto`` consults each shard's fingerprint,
    so a skewed shard can run ``row_loop`` while its neighbours stream.
    ``n_local`` is the panel width each shard multiplies (full N
    in-process; N / col_shards on a 2D mesh), never a chunk's, and a kernel
    backend's N tile is fixed at that width, so a chunk runs the full
    panel's tile."""
    out = []
    for m in smeta.shard_metas:
        be, bn_s = ops.resolve_backend(backend, bn, m, n_local, device=device)
        if bn_s is None and be in ("nnz_stream", "row_loop"):
            bn_s = pk.tile_n(n_local)
        out.append((be, bn_s))
    return tuple(out)


def _mesh_layout(mesh, smeta: ShardedMeta):
    """``(coords, mine)`` of a mesh: each global rank's (shard, column
    block), and this rank's.  Raises where the mesh does not fit the
    operand."""
    sizes = mesh_lib.axis_sizes(mesh)
    S, C = smeta.n_shards, smeta.col_shards
    if sizes.get(AXIS_ROW) != S:
        raise ValueError(
            f"mesh axis {AXIS_ROW!r} must have size {S} "
            f"(got {sizes.get(AXIS_ROW)}); build one with "
            "dist_spmm.make_spmm_mesh")
    if C > 1 and sizes.get(AXIS_COL) != C:
        raise ValueError(
            f"mesh axis {AXIS_COL!r} must have size {C} "
            f"(got {sizes.get(AXIS_COL)})")
    extra = set(sizes) - {AXIS_ROW, AXIS_COL}
    if extra:
        raise ValueError(f"an spmm mesh has the axes {AXIS_ROW!r} and "
                         f"{AXIS_COL!r} only, not {sorted(extra)}")
    ranks = mesh.mesh.reshape(S, -1).tolist()    # [S, col axis size]
    if sum(len(r) for r in ranks) != dist.get_world_size():
        raise ValueError("the spmm mesh must span the whole world")
    coords = {}
    for s, row in enumerate(ranks):
        for c, rank in enumerate(row):
            coords[int(rank)] = (s, c)
    return coords, coords[dist.get_rank()]


def _all_gather_exact(t: torch.Tensor):
    """``all_gather`` over the world, moved as bytes (exact for any type,
    and bf16 travels where a backend has no bf16 collective)."""
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return [p.view(t.dtype).reshape(t.shape) for p in parts]


def _vals_ext(vals: torch.Tensor) -> torch.Tensor:
    """``vals`` with the zero block the sentinel index ``nnzb`` reads."""
    return torch.cat([vals, vals.new_zeros((1,) + tuple(vals.shape[1:]))])


@dataclasses.dataclass(frozen=True)
class _Run:
    """One resolved sharded product: the per-shard kernel configurations
    and where each shard runs.  ``mesh`` is None in-process; on a mesh,
    ``coords`` maps every rank to its (shard, column block) and ``mine`` is
    this rank's."""
    smeta: ShardedMeta
    cfgs: Tuple[ops.SpmmConfig, ...]
    n_chunks: int
    mesh: object = None
    coords: Optional[dict] = None
    mine: Tuple[int, int] = (0, 0)

    def _shard(self, arrays: ShardedArrays, s: int,
               vals_ext: torch.Tensor) -> ops.SparseArrays:
        port = {name: None if getattr(arrays, name) is None
                else getattr(arrays, name)[s] for name in ops.PORT_FIELDS}
        return ops.SparseArrays(
            vals_ext.index_select(0, arrays.src_index[s].long()),
            arrays.row_ids[s], arrays.col_ids[s], arrays.real_mask[s],
            arrays.t_perm[s], arrays.t_row_ids[s], arrays.t_col_ids[s],
            **port)

    def _local(self):
        """(shard, column block) pairs this process computes (a replica on
        a column axis the operand does not split computes block 0)."""
        if self.mesh is None:
            return [(s, 0) for s in range(self.smeta.n_shards)]
        s, c = self.mine
        return [(s, c if self.smeta.col_shards > 1 else 0)]

    def _col_width(self, n: int) -> int:
        return n if self.mesh is None else -(-n // self.smeta.col_shards)

    def _cols(self, x: torch.Tensor, c: int, nc: int) -> torch.Tensor:
        """Column block ``c`` (width ``nc``) of ``x``, zero-padded."""
        if self.mesh is None:
            return x
        n_pad = nc * self.smeta.col_shards - x.shape[1]
        if n_pad:
            x = F.pad(x, (0, n_pad))
        return x[:, c * nc:(c + 1) * nc]

    def _rank(self, s: int, c: int) -> int:
        """The rank holding (shard, column block); with one column block on
        a mesh whose column axis is larger, its column-0 replica."""
        c = c if self.smeta.col_shards > 1 else 0
        return next(r for r, sc in self.coords.items() if sc == (s, c))

    def forward(self, arrays: ShardedArrays, b: torch.Tensor) -> torch.Tensor:
        smeta = self.smeta
        N = int(b.shape[-1])
        nc = self._col_width(N)
        vals_ext = _vals_ext(arrays.vals)
        local = []
        for s, c in self._local():
            arr = self._shard(arrays, s, vals_ext)
            meta, cfg = smeta.shard_metas[s], self.cfgs[s]
            local.append(lambda bc, a_=arr, m_=meta, f_=cfg:
                         ops._fwd_impl(f_, m_, a_, bc))
        if self.mesh is None:
            out_pad = _run_chunked(
                lambda bc: torch.cat([run(bc) for run in local]), b,
                self.n_chunks)
        else:
            mine = _run_chunked(local[0], self._cols(b, self._local()[0][1],
                                                     nc), self.n_chunks)
            parts = _all_gather_exact(mine)
            out_pad = torch.cat([
                torch.cat([parts[self._rank(s, c)]
                           for c in range(smeta.col_shards)], dim=1)
                for s in range(smeta.n_shards)])[:, :N]
        out = out_pad.index_select(0, arrays.gather_rows.long())
        return _combine_splits(out, out_pad, arrays)

    def backward(self, arrays: ShardedArrays, b: torch.Tensor,
                 g: torch.Tensor, need_vals: bool, need_b: bool):
        """``(dvals, dB)`` of the product for the cotangent ``g`` [M, N],
        the unchunked per-shard products only."""
        smeta = self.smeta
        S, C = smeta.n_shards, smeta.col_shards
        h, w = smeta.block
        K, N = int(b.shape[0]), int(b.shape[1])
        nc = self._col_width(N)
        rows = smeta.rows_per_shard * h
        g2 = g.to(b.dtype)
        gp = g2.new_zeros((S * rows, N))
        gp.index_copy_(0, arrays.gather_rows.long(), g2)
        if arrays.split_src is not None and arrays.split_src.numel():
            gp.index_copy_(0, arrays.split_src.long(),
                           g2.index_select(0, arrays.split_dst.long()))
        vals_ext = _vals_ext(arrays.vals)
        dbs, dvs = {}, {}
        for s, c in self._local():
            arr = self._shard(arrays, s, vals_ext)
            meta, cfg = smeta.shard_metas[s], self.cfgs[s]
            g_s = self._cols(gp[s * rows:(s + 1) * rows], c, nc)
            if need_b:
                dbs[s, c] = ops._dx_impl(cfg, meta, arr, g_s)[:K, :nc]
            if need_vals:
                cfg_d = dataclasses.replace(cfg, bn=None,
                                            out_dtype=arrays.vals.dtype)
                dvs[s, c] = ops._sddmm_impl(cfg_d, meta, arr, g_s,
                                            self._cols(b, c, nc))
        if self.mesh is not None:
            # every rank gathers every partial: the sums below then run in
            # the same order on every rank as in-process
            key = self._local()[0]
            for parts in (dbs, dvs):
                if parts:
                    got = _all_gather_exact(parts[key])
                    parts.clear()
                    parts.update({sc: got[r] for r, sc in
                                  self.coords.items()})
        cblocks = range(C) if self.mesh is not None else (0,)
        db = dvals = None
        if need_b:
            acc = None
            for s in range(S):               # ascending shard order, f32
                part = torch.cat([dbs[s, c if C > 1 else 0]
                                  for c in cblocks], dim=1).float()
                acc = part if acc is None else acc + part
            db = acc[:, :N].to(b.dtype)
        if need_vals:
            dext = arrays.vals.new_zeros(
                (smeta.nnzb + 1,) + tuple(arrays.vals.shape[1:]))
            for s in range(S):
                dv = dvs[s, 0]
                if self.mesh is not None and C > 1:
                    acc = dv.float()
                    for c in range(1, C):
                        acc = acc + dvs[s, c].float()
                    dv = acc.to(arrays.vals.dtype)
                # each real entry sits in one slot of one shard: exact
                dext.index_add_(0, arrays.src_index[s].long(), dv)
            dvals = dext[:smeta.nnzb]
        return dvals, db


class _SpmmSharded(torch.autograd.Function):
    """The sharded product as one autograd node: the forward runs the
    (chunked) per-shard kernels, the backward ``_Run.backward``."""

    @staticmethod
    def forward(ctx, run, rest, vals, b):
        ctx.run, ctx.rest = run, rest
        ctx.save_for_backward(vals, b)
        return run.forward(ShardedArrays(vals, *rest), b)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        vals, b = ctx.saved_tensors
        dvals, db = ctx.run.backward(
            ShardedArrays(vals, *ctx.rest), b, g, ctx.needs_input_grad[2],
            ctx.needs_input_grad[3])
        return None, None, dvals, db


def spmm_sharded(arrays: ShardedArrays, smeta: ShardedMeta, b: torch.Tensor,
                 *, backend: str = "auto", bn: Optional[int] = None,
                 mesh=None, out_dtype=None, n_chunks: int = 1
                 ) -> torch.Tensor:
    """C = A @ B over the row-partitioned operand, in original row order.

    ``mesh=None`` runs every shard in-process; a ``DeviceMesh`` with an
    ``AXIS_ROW`` axis of size ``n_shards`` (and ``AXIS_COL`` of size
    ``col_shards`` when 2D), spanning the world, runs one shard per rank
    and gathers the result on every rank.  ``backend="auto"`` resolves one
    (kernel, N tile) per shard from its fingerprint.  ``n_chunks > 1`` runs
    the panel in ascending column chunks; the backward runs the unchunked
    products.  Differentiable w.r.t. ``arrays.vals`` and ``b``.

    >>> import numpy as np, torch
    >>> from repro_torch.core import bcsr as bcsr_lib
    >>> from repro_torch.kernels import ops
    >>> from repro_torch.launch import dist_spmm
    >>> a = bcsr_lib.random_bcsr_exact(7, (320, 256), (16, 16), nnzb=80)
    >>> sharr, smeta = dist_spmm.prepare_sharded(a, 4, dtype=torch.float32,
    ...                                          device="cpu")
    >>> b = torch.from_numpy(np.random.default_rng(0).standard_normal(
    ...     (256, 32)).astype(np.float32))
    >>> c = dist_spmm.spmm_sharded(sharr, smeta, b, backend="xla")
    >>> arrays, meta = ops.prepare_sparse(a, torch.float32, device="cpu")
    >>> bool(torch.allclose(c, ops.spmm(arrays, meta, b, backend="xla"),
    ...                     atol=1e-4))
    True
    """
    n = int(b.shape[-1])
    sched = chunk_schedule(n, n_chunks)
    if obs_trace.enabled():
        obs_trace.event("dist.chunk_schedule", n=n, n_chunks=len(sched),
                        n_shards=smeta.n_shards, backend=backend,
                        schedule=sched)
    obs_metrics.gauge("dist.n_chunks").set(n_chunks)
    if mesh is None:
        # the FULL panel per shard: picks for N, never for a chunk's width
        choices = _resolve_shard_choices(smeta, n, backend, bn, b.device)
        coords, mine = None, (0, 0)
    else:
        coords, mine = _mesh_layout(mesh, smeta)
        choices = _resolve_shard_choices(
            smeta, -(-n // smeta.col_shards), backend, bn, b.device)
    run = _Run(smeta, tuple(ops.SpmmConfig(backend=be, bn=bn_s,
                                           out_dtype=out_dtype)
                            for be, bn_s in choices),
               n_chunks, mesh, coords, mine)
    if ops._needs_graph(arrays.vals, b):
        return _SpmmSharded.apply(run, tuple(arrays[1:]), arrays.vals, b)
    return run.forward(arrays, b)


# ------------------------------------------------------------------- tuning
def _timed(fn, device: torch.device, warmup: int, iters: int) -> float:
    """Median seconds of ``iters`` calls of ``fn`` after ``warmup``, CUDA
    events on the card (``autotune._time_once``)."""
    from repro_torch.kernels import autotune
    for _ in range(max(warmup, 1)):
        fn()
    autotune._sync(device)
    return float(np.median([autotune._time_once(fn, device)
                            for _ in range(iters)]))


def tune_shards(arrays: ShardedArrays, smeta: ShardedMeta, n: int, *,
                warmup: int = 1, iters: int = 3, rng_seed: int = 0,
                layout: str = "row_major", tuner=None) -> dict:
    """Timed per-shard sweep (the sharded ``Autotuner.tune``): times every
    SpMM candidate on each shard's own slice, on the device of
    ``arrays.vals``, and caches the fastest kernel under the shard's
    fingerprint (the JAX package's key plus ``|dev=``), so later
    ``backend="auto"`` dispatch picks measured winners per shard.  Shards
    whose fingerprints coincide are timed once.  The yardsticks (``xla``,
    ``dense``) are timed and never picked; the default kernel wins ties
    within 2%.  ``layout`` is ``Autotuner.tune``'s.  Returns
    ``{key: choice}``."""
    from repro_torch.kernels import autotune
    if layout not in ("row_major", "token_major"):
        raise ValueError(f"unknown layout {layout!r}; want 'row_major' "
                         "or 'token_major'")
    tuner = tuner if tuner is not None else autotune.get_autotuner()
    device = arrays.vals.device
    dev_name = autotune.device_name(device)
    rng = np.random.default_rng(rng_seed)
    K = smeta.shape[1]
    if layout == "token_major":
        b = torch.from_numpy(rng.standard_normal((n, K)).astype(
            np.float32)).to(device, arrays.vals.dtype).T
    else:
        b = torch.from_numpy(rng.standard_normal((K, n)).astype(
            np.float32)).to(device, arrays.vals.dtype)
    run = _Run(smeta, (), 1)
    vals_ext = _vals_ext(arrays.vals)
    default_label = f"{autotune.DEFAULT_VARIANT}/bn{autotune.DEFAULT_BN}"
    tuned: dict = {}
    with torch.inference_mode():
        for s, meta_s in enumerate(smeta.shard_metas):
            fp = autotune.fingerprint(meta_s, n, device=dev_name)
            if fp.key() in tuned:
                continue
            arr = run._shard(arrays, s, vals_ext)
            cand = {}
            for name in autotune.variant_names("spmm"):
                v = autotune.get_variant(name)
                if not v.supported(meta_s):
                    continue
                bns = {autotune.pick_bn(meta_s, n, v.bn_candidates)}
                bns.update(bn for bn in v.bn_candidates
                           if bn <= max(n, min(v.bn_candidates)))
                for bn in sorted(bns):
                    cand[f"{name}/bn{bn}"] = (name, bn)
            cand.setdefault(default_label, (autotune.DEFAULT_VARIANT,
                                            autotune.DEFAULT_BN))
            timings = {}
            for label, (name, bn) in cand.items():
                be = autotune.get_variant(name).backend
                timings[label] = _timed(
                    lambda _be=be, _bn=bn: ops.spmm(arr, meta_s, b,
                                                    backend=_be, bn=_bn),
                    device, warmup, iters)
            best = min((lb for lb, (name, _) in cand.items()
                        if autotune.get_variant(name).is_kernel),
                       key=timings.get)
            if timings[default_label] <= timings[best] * 1.02:
                best = default_label          # the default wins ties
            name, bn = cand[best]
            choice = autotune.KernelChoice(name, bn, source="measured",
                                           predicted_us=timings[best] * 1e6)
            tuner.put(fp, choice, persist=True)
            tuned[fp.key()] = choice
    return tuned


def tune_shard_count(a: bcsr_lib.BCSR, n: int, *, max_shards: int = 8,
                     n_chunks: int = 1, backend: str = "auto",
                     bn: Optional[int] = None, dtype=torch.float32,
                     warmup: int = 1, iters: int = 3, rng_seed: int = 0,
                     tuner=None, device="cuda"):
    """Timed shard-count sweep, the measured counterpart of
    :func:`resolve_n_shards`: prepares the operand at each candidate S,
    times the in-process ``spmm_sharded`` (its host issue included, CUDA
    events on the card) with the requested chunk depth, and caches the
    winner under the operand's ``nk=`` fingerprint on ``device``, so later
    ``resolve_n_shards`` calls return it.  A count the structure cannot fit
    is not a candidate.  Smaller S wins ties within 2%.  Returns the
    ``ShardChoice``."""
    from repro_torch.kernels import autotune
    tuner = tuner if tuner is not None else autotune.get_autotuner()
    device = torch.device(device)
    meta = ops.prepare_sparse_meta(a)
    fp = autotune.fingerprint(meta, n, n_chunks=n_chunks,
                              device=autotune.device_name(device))
    rng = np.random.default_rng(rng_seed)
    b = torch.from_numpy(rng.standard_normal((a.shape[1], n)).astype(
        np.float32)).to(device, dtype)

    timings = {}
    with torch.inference_mode():
        for s in autotune.shard_candidates(max_shards, meta.n_block_rows):
            try:
                sharr, smeta = prepare_sharded(a, s, dtype=dtype,
                                               device=device)
            except ValueError:      # unfittable at this S: not a candidate
                continue
            timings[s] = _timed(
                lambda _a=sharr, _m=smeta: spmm_sharded(
                    _a, _m, b, backend=backend, bn=bn, n_chunks=n_chunks),
                device, warmup, iters)
    if not timings:
        choice = autotune.analytic_shard_choice(
            meta, n, max_shards=max_shards, n_chunks=n_chunks)
    else:
        t_best = min(timings.values())
        best = next(s for s in sorted(timings)
                    if timings[s] <= t_best * 1.02)
        choice = autotune.ShardChoice(best, source="measured",
                                      predicted_us=timings[best] * 1e6)
    tuner.put_shards(fp, max_shards, choice, persist=True)
    return choice


# ---------------------------------------------------------------- reporting
def shard_balance_stats(a: bcsr_lib.BCSR, n_shards: int, *,
                        rows_per_shard: Optional[int] = None) -> dict:
    """Host-side per-shard nnzb balance report.

    ``imbalance`` is max/mean per-shard load (1.0 = perfect);
    ``contig_imbalance`` is the same for a naive contiguous equal-row
    split: the balance the LPT assignment buys over doing nothing."""
    a_p = a.ensure_nonempty_rows()
    _, _, loads, rps = plan_shards(a_p, n_shards,
                                   rows_per_shard=rows_per_shard)
    bpr = np.diff(a_p.rowptr)
    nbr = bpr.size
    contig = np.asarray(
        [int(bpr[s * rps: (s + 1) * rps].sum()) for s in range(n_shards)],
        np.int64)
    mean = float(loads.mean()) if n_shards else 0.0

    def imb(x):
        m = float(x.mean())
        return round(float(x.max()) / m, 4) if m > 0 else 1.0

    return {
        "n_shards": int(n_shards),
        "n_block_rows": int(nbr),
        "rows_per_shard": int(rps),
        "nnzb": int(a_p.nnzb),
        "loads": [int(x) for x in loads],
        "load_mean": round(mean, 2),
        "load_max": int(loads.max()) if n_shards else 0,
        "imbalance": imb(loads),
        "contig_imbalance": imb(contig),
        "load_cv_pct": int(round(100 * float(loads.std()) / mean))
        if mean > 0 else 0,
    }
