"""Pre-launch static verification of schedules, grids and shared memory,
held to the H100's budgets.

Everything that makes the CUDA kernels correct is decided BEFORE any
device tensor exists: the (block-row x slot) static schedule and its
sentinel padding, the grid derived from (meta, N, tile), the CTA's shared
memory and, once a library is built, each compiled function's registers.
On the card none of these is a compile error: a bad schedule index is an
out-of-bounds read (B3, B4 and B5 never check ``flat_idx``/``flat_col`` on
the device), and an oversized CTA or grid is a refused launch.  This pass
re-derives each of them on the host and checks the contracts the kernels
assume.  It is the twin of ``repro.analysis.verify_launch``, function by
function:

* **coverage** -- every live entry appears in the schedule exactly once;
  sentinels (entry 0 for the spmm family, entry ``nnzb`` for sddmm/attn)
  appear ONLY on padding slots;
* **bounds** -- every index the schedule can hand a kernel stays inside
  the operand shapes;
* **shape** -- block shapes divide the matrix dims or rag them by less
  than one block (``nbr == ceil(M/h)``, ``nbc == ceil(K/w)``);
* **grid** -- the CUDA grid of each kernel (``derive_grid``: B1/B3
  ``(nbr, ceil(N/BN), ceil(h/BM))``, B2/B4 ``(entries, ceil(h/64),
  ceil(w/64))``, B5 ``(nbr * slices, G, ceil(dv/128))``) inside the
  card's limits (``gridDim.y``/``z`` <= 65,535);
* **shared memory** -- the CTA's static + dynamic shared memory, from the
  kernels' own formulas (``analysis.workspace``), within a budget: by
  default the H100's 232,448 bytes a CTA.  The JAX package checks a TPU
  VMEM budget here; the argument keeps its JAX name ``vmem_budget``;
* **resources** (new here) -- ``resource_usage`` reads each compiled
  function's registers, static shared memory and local memory from
  ``cuobjdump -res-usage``, and ``verify_resources`` holds them to the
  SM's register file, the 255-register cap, the kernel's
  ``__launch_bounds__`` minimum CTAs and the shared-memory limit, and
  reports the CTAs an SM holds.

Entry points: ``verify_meta`` / ``verify_sharded_meta`` (invariants of a
meta alone), ``verify_schedule`` (a concrete schedule against its meta),
``verify_launch`` / ``assert_launch_ok`` (the opt-in
``REPRO_VERIFY_LAUNCH=1`` hook inside ``ops.resolve_backend``),
``verify_chunk_schedule``, ``verify_page_table``, ``verify_summary`` (for
a dry-run report), ``run_verify`` (the CLI pass over the structure zoo)
and ``verify_library_resources`` (``chip_smoke.py``'s pass over the built
libraries).

>>> import numpy as np
>>> from repro_torch.core import bcsr as bcsr_lib
>>> from repro_torch.kernels import ops
>>> a = bcsr_lib.random_bcsr_exact(0, (128, 128), (16, 16), 24)
>>> meta = ops.prepare_sparse_meta(a)
>>> verify_meta(meta)
[]
>>> fi, fc = sddmm_row_loop_schedule_host(a.row_ids, a.col_ids,
...                                       meta.n_block_rows, meta.max_bpr)
>>> verify_schedule("sddmm", fi, fc, a.row_ids, a.col_ids, meta)
[]
>>> bad = fi.copy(); bad[np.flatnonzero(fi != meta.nnzb)[0]] = meta.nnzb
>>> len(verify_schedule("sddmm", bad, fc, a.row_ids, a.col_ids, meta)) > 0
True
>>> derive_grid(meta, "spmm", 2048)
(8, 32, 1)
"""
from __future__ import annotations

import dataclasses
import re
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.analysis import workspace
from repro_torch.analysis.report import Finding

FAMILIES = ("spmm", "sddmm", "attn")


class LaunchError(ValueError):
    """A meta/schedule/budget contract is violated for the requested
    launch -- raised by ``assert_launch_ok`` before any kernel dispatch."""


# ------------------------------------------------------- schedule mirrors
def spmm_row_loop_schedule_host(row_ids, col_ids, n_block_rows: int,
                                max_bpr: int):
    """Host-numpy twin of ``ops._row_loop_schedule``, re-derived here so
    the verifier does not trust the producer: per (block-row, slot) the
    entry index and block-col, padding slots pointing at entry 0 / col 0,
    plus the per-row live count ``row_len`` kernel B3 bounds its loop
    with."""
    row_ids = np.asarray(row_ids, np.int64)
    col_ids = np.asarray(col_ids, np.int64)
    nnzb = row_ids.shape[0]
    row_len = np.bincount(row_ids, minlength=n_block_rows)
    rowptr = np.concatenate([[0], np.cumsum(row_len)])
    slot = np.arange(nnzb) - rowptr[row_ids]
    pos = row_ids * max_bpr + slot
    flat_idx = np.zeros(n_block_rows * max_bpr, np.int32)
    flat_col = np.zeros(n_block_rows * max_bpr, np.int32)
    flat_idx[pos] = np.arange(nnzb, dtype=np.int32)
    flat_col[pos] = col_ids
    return flat_idx, flat_col, row_len.astype(np.int32)


def sddmm_row_loop_schedule_host(row_ids, col_ids, n_block_rows: int,
                                 max_bpr: int):
    """Host-numpy twin of ``ops._sddmm_row_loop_schedule`` AND of the
    fused-attention schedule (``models.attention.mask_tensors`` reads the
    same arrays): padding slots point at the sentinel entry ``nnzb``
    instead of entry 0 (B4 and B5 skip them)."""
    row_ids = np.asarray(row_ids, np.int64)
    col_ids = np.asarray(col_ids, np.int64)
    nnzb = row_ids.shape[0]
    row_len = np.bincount(row_ids, minlength=n_block_rows)
    rowptr = np.concatenate([[0], np.cumsum(row_len)])
    slot = np.arange(nnzb) - rowptr[row_ids]
    pos = row_ids * max_bpr + slot
    flat_idx = np.full(n_block_rows * max_bpr, nnzb, np.int32)
    flat_col = np.zeros(n_block_rows * max_bpr, np.int32)
    flat_idx[pos] = np.arange(nnzb, dtype=np.int32)
    flat_col[pos] = col_ids
    return flat_idx, flat_col


def build_schedule(family: str, row_ids, col_ids, meta):
    """(flat_idx, flat_col, row_len|None) for ``family`` from the sorted
    entry list -- the schedule the kernels would actually launch with."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; want one of {FAMILIES}")
    if family == "spmm":
        return spmm_row_loop_schedule_host(
            row_ids, col_ids, meta.n_block_rows, meta.max_bpr)
    fi, fc = sddmm_row_loop_schedule_host(
        row_ids, col_ids, meta.n_block_rows, meta.max_bpr)
    return fi, fc, None


# ------------------------------------------------------- meta invariants
def verify_meta(meta) -> list:
    """Structural invariants of one ``SparseMeta`` -- no arrays involved.

    Dims-only specs metas (``max_bpr == 0``) are legal: they carry shape
    budgets, not a realized structure, and the row_loop family refuses
    them separately.  Shard-local metas (``n_shards > 1``) may contain
    duplicate (row, col) slots (padding), so the distinct-entries bound
    ``nnzb <= nbr * nbc`` applies only to whole-matrix metas."""
    errs = []
    h, w = meta.block
    M, K = meta.shape
    nbr, nbc = meta.n_block_rows, meta.n_block_cols
    if h <= 0 or w <= 0:
        errs.append(f"block {meta.block} must be positive")
        return errs
    if M <= 0 or K <= 0:
        errs.append(f"shape {meta.shape} must be positive")
        return errs
    if nbr != -(-M // h):
        errs.append(f"n_block_rows={nbr} != ceil({M}/{h})={-(-M // h)} "
                    "(block must divide or rag M by < one block)")
    if nbc != -(-K // w):
        errs.append(f"n_block_cols={nbc} != ceil({K}/{w})={-(-K // w)}")
    if meta.nnzb < 0:
        errs.append(f"nnzb={meta.nnzb} < 0")
    if meta.n_shards == 1 and meta.nnzb > nbr * nbc:
        errs.append(f"nnzb={meta.nnzb} exceeds the {nbr}x{nbc} distinct "
                    "block capacity of a whole-matrix meta")
    if not (meta.nnzb <= meta.nnzb_t <= meta.nnzb + nbc):
        errs.append(f"nnzb_t={meta.nnzb_t} outside [nnzb, nnzb + nbc] = "
                    f"[{meta.nnzb}, {meta.nnzb + nbc}] (transpose structure "
                    "adds at most one sentinel per t-block-row)")
    if meta.max_bpr < 0:
        errs.append(f"max_bpr={meta.max_bpr} < 0")
    elif meta.n_shards == 1 and meta.max_bpr > nbc:
        # shard-local metas (n_shards > 1) may exceed nbc: padding slots
        # duplicate (row 0, col 0) and count toward the schedule bound
        errs.append(f"max_bpr={meta.max_bpr} outside [0, n_block_cols={nbc}]")
    if meta.max_bpr > 0:
        if meta.nnzb > nbr * meta.max_bpr:
            errs.append(
                f"schedule capacity violated: nnzb={meta.nnzb} > "
                f"n_block_rows*max_bpr={nbr * meta.max_bpr} — some entry "
                "has no (row, slot) to live in")
        if meta.max_bpr > meta.nnzb:
            errs.append(f"max_bpr={meta.max_bpr} > nnzb={meta.nnzb}")
        if meta.n_shards == 1 and meta.nnzb < nbr:
            errs.append(
                f"nnzb={meta.nnzb} < n_block_rows={nbr} with max_bpr > 0 — "
                "prepared metas pad every block-row nonempty")
    if not (0 <= meta.padding_ratio_pct <= 100):
        errs.append(f"padding_ratio_pct={meta.padding_ratio_pct} not a pct")
    if meta.bpr_cv_pct < 0:
        errs.append(f"bpr_cv_pct={meta.bpr_cv_pct} < 0")
    if meta.n_shards < 1:
        errs.append(f"n_shards={meta.n_shards} < 1")
    return errs


def verify_sharded_meta(smeta) -> list:
    """Invariants of a ``ShardedMeta``: global bookkeeping plus every
    per-shard ``SparseMeta`` (checked via ``verify_meta``)."""
    errs = []
    h, w = smeta.block
    M, K = smeta.shape
    nbr = -(-M // h)
    if smeta.n_shards < 1 or smeta.col_shards < 1:
        errs.append(f"n_shards={smeta.n_shards}, col_shards="
                    f"{smeta.col_shards} must be >= 1")
        return errs
    if len(smeta.shard_metas) != smeta.n_shards:
        errs.append(f"{len(smeta.shard_metas)} shard_metas != n_shards="
                    f"{smeta.n_shards}")
        return errs
    if smeta.rows_per_shard * smeta.n_shards < nbr:
        errs.append(f"rows_per_shard={smeta.rows_per_shard} x n_shards="
                    f"{smeta.n_shards} cannot hold {nbr} block-rows")
    if smeta.nnzb_t_per_shard != smeta.nnzb_per_shard + -(-K // w):
        errs.append(f"nnzb_t_per_shard={smeta.nnzb_t_per_shard} != "
                    f"nnzb_per_shard + n_block_cols (shape-deterministic "
                    "t-structure contract)")
    for s, m in enumerate(smeta.shard_metas):
        sub = verify_meta(m)
        errs += [f"shard {s}: {e}" for e in sub]
        if m.shape != (smeta.rows_per_shard * h, K):
            errs.append(f"shard {s}: shape {m.shape} != "
                        f"{(smeta.rows_per_shard * h, K)}")
        if m.nnzb != smeta.nnzb_per_shard:
            errs.append(f"shard {s}: nnzb={m.nnzb} != nnzb_per_shard="
                        f"{smeta.nnzb_per_shard}")
        if m.block != smeta.block:
            errs.append(f"shard {s}: block {m.block} != {smeta.block}")
        if m.n_shards != smeta.n_shards:
            errs.append(f"shard {s}: n_shards={m.n_shards} != "
                        f"{smeta.n_shards}")
    return errs


# ---------------------------------------------------- schedule verification
def verify_schedule(family: str, flat_idx, flat_col, row_ids, col_ids,
                    meta, row_len=None) -> list:
    """Check one realized (block-row x slot) schedule against its meta.

    ``family`` fixes the sentinel convention: ``"spmm"`` pads with entry 0
    and needs ``row_len`` (B3's loop bound); ``"sddmm"``/``"attn"`` pad
    with the sentinel entry index ``nnzb``.  Returns a list of error
    strings -- empty means the schedule covers every live slot exactly
    once, sentinels sit only on padding, every index is in bounds, and
    the (row, col) bookkeeping is self-consistent."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; want one of {FAMILIES}")
    errs = []
    flat_idx = np.asarray(flat_idx, np.int64)
    flat_col = np.asarray(flat_col, np.int64)
    row_ids = np.asarray(row_ids, np.int64)
    col_ids = np.asarray(col_ids, np.int64)
    nnzb, nbr, nbc = meta.nnzb, meta.n_block_rows, meta.n_block_cols
    max_bpr = meta.max_bpr
    if max_bpr <= 0:
        return [f"{family}: meta.max_bpr={max_bpr} — no static schedule "
                "exists for a dims-only meta"]
    want_len = nbr * max_bpr
    if flat_idx.shape[0] != want_len or flat_col.shape[0] != want_len:
        return [f"{family}: schedule length {flat_idx.shape[0]} != "
                f"n_block_rows*max_bpr={want_len}"]
    if row_ids.shape[0] != nnzb:
        return [f"{family}: entry list length {row_ids.shape[0]} != "
                f"meta.nnzb={nnzb}"]
    if row_ids.size and (row_ids.min() < 0 or row_ids.max() >= nbr):
        errs.append(f"{family}: entry row_ids outside [0, {nbr})")
    if col_ids.size and (col_ids.min() < 0 or col_ids.max() >= nbc):
        errs.append(f"{family}: entry col_ids outside [0, {nbc})")
    if np.any(np.diff(row_ids) < 0):
        errs.append(f"{family}: entry list not sorted row-major "
                    "(row_ids must be nondecreasing)")
    if errs:
        return errs

    counts = np.bincount(row_ids, minlength=nbr)
    if counts.max(initial=0) > max_bpr:
        return [f"{family}: a block-row holds {int(counts.max())} entries "
                f"> max_bpr={max_bpr} — schedule cannot represent it"]
    slots = np.arange(want_len) % max_bpr
    seg_row = np.arange(want_len) // max_bpr
    if family == "spmm":
        if row_len is None:
            return [f"{family}: row_len is required (the kernel's loop "
                    "bound) for the spmm family"]
        row_len = np.asarray(row_len, np.int64)
        if row_len.shape[0] != nbr:
            return [f"{family}: row_len length {row_len.shape[0]} != "
                    f"n_block_rows={nbr}"]
        if not np.array_equal(row_len, counts):
            bad = int(np.flatnonzero(row_len != counts)[0])
            errs.append(
                f"{family}: row_len[{bad}]={int(row_len[bad])} != true "
                f"entry count {int(counts[bad])} — the loop mask drops or "
                "double-visits slots")
        live = slots < row_len[seg_row]
        # in-bounds: every slot (live or padding) indexes a real entry
        if flat_idx.min() < 0 or flat_idx.max() >= max(nnzb, 1):
            errs.append(f"{family}: flat_idx outside [0, nnzb={nnzb}) — "
                        "spmm padding must reuse entry 0, not a sentinel")
        pad_bad = np.flatnonzero(~live & ((flat_idx != 0) | (flat_col != 0)))
        if pad_bad.size:
            errs.append(f"{family}: {pad_bad.size} padding slot(s) (first "
                        f"at {int(pad_bad[0])}) not pointing at entry 0 / "
                        "col 0")
    else:
        live = flat_idx != nnzb
        if flat_idx.min() < 0 or flat_idx.max() > nnzb:
            errs.append(f"{family}: flat_idx outside [0, nnzb={nnzb}] "
                        "(sentinel row is index nnzb)")
        live_counts = np.bincount(seg_row[live], minlength=nbr)
        if not np.array_equal(live_counts, counts):
            bad = int(np.flatnonzero(live_counts != counts)[0])
            errs.append(
                f"{family}: block-row {bad} schedules "
                f"{int(live_counts[bad])} live slot(s) but owns "
                f"{int(counts[bad])} entries — sentinel on a live block "
                "or a dropped slot")
        pad_bad = np.flatnonzero(~live & (flat_col != 0))
        if pad_bad.size:
            errs.append(f"{family}: {pad_bad.size} sentinel slot(s) with "
                        "nonzero flat_col (must DMA block-col 0)")
    if errs:
        return errs

    live_idx = flat_idx[live]
    if not np.array_equal(np.sort(live_idx), np.arange(nnzb)):
        missing = np.setdiff1d(np.arange(nnzb), live_idx)
        dupes = live_idx.size - np.unique(live_idx).size
        errs.append(
            f"{family}: live slots are not a permutation of the {nnzb} "
            f"entries ({missing.size} dropped, {dupes} duplicated) — "
            "coverage contract violated")
        return errs
    if not np.array_equal(row_ids[live_idx], seg_row[live]):
        errs.append(f"{family}: a live slot's entry belongs to a different "
                    "block-row than its schedule segment")
    if not np.array_equal(flat_col[live], col_ids[live_idx]):
        errs.append(f"{family}: flat_col disagrees with the entry list's "
                    "col_ids — the kernel would DMA the wrong B/K panel")
    if flat_col.min() < 0 or flat_col.max() >= nbc:
        errs.append(f"{family}: flat_col outside [0, n_block_cols={nbc})")
    return errs


# ---------------------------------------------- grid + shared memory checks
_KERNELS = {("spmm", "nnz_stream"): "B1", ("sddmm", "nnz_stream"): "B2",
            ("spmm", "row_loop"): "B3", ("sddmm", "row_loop"): "B4",
            ("attn", "fused"): "B5", ("attn", "row_loop"): "B5"}
_KERNEL_FAMILY = {"B1": "spmm", "B2": "sddmm", "B3": "spmm", "B4": "sddmm",
                  "B5": "attn"}


def kernel_for(backend: str, op: str) -> Optional[str]:
    """The CUDA kernel (``"B1"`` .. ``"B5"``) a resolved launch runs, or
    None for the plain backends (``xla``, ``dense``, ``composed``)."""
    backend = "nnz_stream" if backend == "pallas" else backend
    return _KERNELS.get((op, backend))


def _spmm_tile(n: int, h: int, bn: Optional[int]):
    """(BM, BN) of a B1/B3 launch: the wrapper's row block
    (``bcsr_spmm.spmm_row_block``) and the given tile or the kernel's own
    (``bcsr_spmm.tile_n``)."""
    from repro_torch.kernels import bcsr_spmm as pk
    return pk.spmm_row_block(n, h), (bn or pk.tile_n(n))


def derive_grid(meta, family: str, n: int, bn: Optional[int] = None, *,
                backend: str = "row_loop", instances: int = 1,
                dv: Optional[int] = None):
    """The CUDA grid one launch of ``family`` over ``instances`` instances
    runs with (``n`` is N for the spmm/sddmm families, the head width d for
    attn): B1/B3 ``(nbr * instances, ceil(N/BN), ceil(h/BM))``
    (``spmm_tile.cuh`` ``launch``: the instance axis folded into x);
    B2/B4 ``(entries * instances, ceil(h/64), ceil(w/64))`` with
    ``entries`` the stored entries (B2, ``backend="nnz_stream"``) or
    schedule slots (B4) (``sddmm_tile.cuh``); B5 ``(nbr * slices,
    instances, ceil(dv/128))`` with ``slices`` the CTAs a block-row's rows
    take (``bcsr_attn.cu``)."""
    h, w = meta.block
    nbr = meta.n_block_rows
    if family == "spmm":
        bm, tile = _spmm_tile(n, h, bn)
        return (nbr * instances, -(-n // tile), -(-h // bm))
    if family == "sddmm":
        entries = meta.nnzb if backend in ("nnz_stream", "pallas") \
            else nbr * meta.max_bpr
        t = workspace.SDDMM_TILE
        return (entries * instances, -(-h // t), -(-w // t))
    if family == "attn":
        slices = -(-h // (16 * workspace.attn_warps(h)))
        return (nbr * slices, instances,
                -(-(dv or n) // workspace.ATTN_CHUNK))
    raise ValueError(f"unknown family {family!r}")


def grid_errors(grid, what: str = "") -> list:
    """The card's grid limits: every dimension at least 1, ``gridDim.x``
    at most 2**31 - 1, ``gridDim.y`` and ``gridDim.z`` at most 65,535."""
    errs = []
    if any(g <= 0 for g in grid):
        errs.append(f"degenerate grid {grid}{what}")
    limits = (workspace.H100_GRID_X, workspace.H100_GRID_YZ,
              workspace.H100_GRID_YZ)
    for axis, g, lim in zip("xyz", grid, limits):
        if g > lim:
            errs.append(f"grid {grid}{what}: gridDim.{axis}={g} exceeds the "
                        f"card's limit {lim} — the launch would be refused")
    return errs


_DTYPES = ("float32", "bfloat16")


def _spmm_cta_bytes(n: int, h: int, bn: Optional[int]) -> int:
    """Static + dynamic shared memory of a B1/B3 CTA at N = ``n`` for
    blocks of ``h`` rows: the larger of both types' instantiations and of
    B's two stagings (a stride decides it at launch)."""
    bm, tile = _spmm_tile(n, h, bn)
    return workspace.SPMM_STATIC_SMEM + max(
        workspace.spmm_smem_bytes(dt, bm, tile, km)
        for dt in _DTYPES for km in (False, True))


def estimate_vmem_bytes(meta, family: str, n: int,
                        bn: Optional[int] = None) -> int:
    """Shared memory, bytes, one CTA of ``family``'s kernel takes: static
    plus dynamic, from the kernels' own formulas (``analysis.workspace``;
    ``n`` is N for the spmm/sddmm families, the head width d for attn):
    the larger of the float32 and bfloat16 instantiations, and of B's
    (B1/B3) or both operands' (B2/B4) two stagings, since the operands'
    types and strides decide those at launch.  The name is the JAX
    package's, whose VMEM estimate this replaces."""
    h, _ = meta.block
    if family == "spmm":
        return _spmm_cta_bytes(n, h, bn)
    if family == "sddmm":
        return workspace.SDDMM_STATIC_SMEM + max(
            workspace.sddmm_smem_bytes(dt, ak, bk) for dt in _DTYPES
            for ak in (False, True) for bk in (False, True))
    if family == "attn":
        return workspace.ATTN_STATIC_SMEM + workspace.attn_smem_bytes(
            n, h, meta.max_bpr)
    raise ValueError(f"unknown family {family!r}")


def _family_for(backend: str, op: str) -> Optional[str]:
    """Which static-schedule family (if any) a resolved backend launches.
    ``None`` = no row_loop-style schedule (nnz_stream / xla / dense)."""
    if op == "attn":
        return "attn" if backend in ("fused", "row_loop") else None
    if backend == "row_loop":
        return op if op in ("spmm", "sddmm") else "spmm"
    return None


def verify_launch(meta, backend: str, *, n: int, bn: Optional[int] = None,
                  op: str = "spmm",
                  vmem_budget: int = workspace.H100_SMEM_PER_CTA,
                  instances: int = 1) -> list:
    """All static checks for one resolved (meta, backend, n, bn, op)
    launch over ``instances`` instances: meta invariants, schedule
    feasibility for the backend's family, the kernel's grid against the
    card's limits, its widths (B5: d <= 256, block width <= 128) and its
    CTA's shared memory against ``vmem_budget`` (the JAX name kept; by
    default the H100's 232,448 bytes a CTA).  ``n`` is N, or the head
    width d (= dv) for ``op="attn"``.  Returns error strings (empty =
    ok)."""
    errs = list(verify_meta(meta))
    family = _family_for(backend, op)
    if family is not None and meta.max_bpr <= 0:
        errs.append(f"backend {backend!r} (family {family}) needs "
                    "meta.max_bpr > 0; this is a dims-only meta")
    if family is not None and meta.max_bpr > 0:
        sched_len = meta.n_block_rows * meta.max_bpr
        if sched_len < meta.nnzb:
            errs.append(f"schedule length {sched_len} cannot cover "
                        f"nnzb={meta.nnzb}")
    kernel = kernel_for(backend, op)
    if kernel is None or (family is not None and meta.max_bpr <= 0):
        return errs
    kfam = _KERNEL_FAMILY[kernel]
    each = f", instances={instances}" if instances > 1 else ""
    what = f" of {kernel} (block={meta.block}, n={n}, bn={bn}{each})"
    errs += grid_errors(derive_grid(meta, kfam, n, bn, backend=backend,
                                    instances=instances), what)
    if kernel == "B5":
        w = meta.block[1]
        if n > workspace.ATTN_MAX_D or w > workspace.ATTN_MAX_W:
            errs.append(f"B5 holds d, dv <= {workspace.ATTN_MAX_D} and a "
                        f"block width <= {workspace.ATTN_MAX_W}; got d={n}, "
                        f"w={w}")
    need = estimate_vmem_bytes(meta, kfam, n, bn)
    if need > vmem_budget:
        errs.append(
            f"{kernel} needs {need} B of shared memory a CTA (static + "
            f"dynamic) for block={meta.block}, n={n}, bn={bn}, "
            f"max_bpr={meta.max_bpr}, over the budget {vmem_budget} B — "
            "the launch would be refused")
    return errs


def assert_launch_ok(meta, backend: str, *, n: int, bn: Optional[int] = None,
                     op: str = "spmm",
                     vmem_budget: int = workspace.H100_SMEM_PER_CTA,
                     instances: int = 1):
    """Raise ``LaunchError`` if the resolved launch (over ``instances``
    instances) violates any static contract -- the
    ``REPRO_VERIFY_LAUNCH=1`` hook in ``ops.resolve_backend``.
    ``vmem_budget`` keeps the JAX package's name for the shared-memory
    budget of a CTA."""
    errs = verify_launch(meta, backend, n=n, bn=bn, op=op,
                         vmem_budget=vmem_budget, instances=instances)
    if errs:
        each = f", instances={instances}" if instances > 1 else ""
        raise LaunchError(
            f"pre-launch verification failed for backend={backend!r}, "
            f"op={op!r}, n={n}, bn={bn}{each}:\n  - " + "\n  - ".join(errs))


def verify_chunk_schedule(bounds, n: int, *, block=None,
                          bn: Optional[int] = None,
                          vmem_budget: int =
                          workspace.H100_SMEM_PER_CTA) -> list:
    """Invariants of an overlap chunk schedule (``dist_spmm
    .chunk_schedule``): the chunks must partition ``[0, n)`` EXACTLY —
    contiguous, strictly ascending, non-empty, no gaps or overlaps — or
    the chunked product is not the single-shot panel (dropped/duplicated
    columns).  With ``block`` given, each chunk's SpMM CTA must also fit
    the shared-memory budget (chunk widths never exceed the full panel,
    so this catches only schedules someone hand-built wrong).  Returns
    error strings (empty = ok)."""
    errs = []
    try:
        bounds = [(int(lo), int(hi)) for lo, hi in bounds]
    except (TypeError, ValueError):
        return [f"chunk schedule {bounds!r} is not a list of (start, stop)"]
    if not bounds:
        return [f"chunk schedule empty for panel width n={n}"]
    if bounds[0][0] != 0:
        errs.append(f"first chunk starts at {bounds[0][0]}, not 0")
    if bounds[-1][1] != n:
        errs.append(f"last chunk stops at {bounds[-1][1]}, not n={n} — "
                    "the schedule does not cover the panel")
    for i, (lo, hi) in enumerate(bounds):
        if hi <= lo:
            errs.append(f"chunk {i} ({lo}, {hi}) is empty or descending")
    for i in range(1, len(bounds)):
        prev_hi, lo = bounds[i - 1][1], bounds[i][0]
        if lo != prev_hi:
            kind = ("overlap (columns accumulated twice)" if lo < prev_hi
                    else "gap (columns dropped)")
            errs.append(f"chunk {i} starts at {lo} but chunk {i - 1} "
                        f"stopped at {prev_hi} — {kind}")
    if block is not None and not errs:
        h = int(tuple(block)[0])
        for i, (lo, hi) in enumerate(bounds):
            need = _spmm_cta_bytes(hi - lo, h, bn)
            if need > vmem_budget:
                errs.append(
                    f"chunk {i} width {hi - lo}: the SpMM CTA needs {need} "
                    f"B of shared memory, over the budget {vmem_budget} B")
    return errs


def verify_page_table(mask, seq_len: int, block,
                      resident_pages=None) -> list:
    """Paged-KV page-table invariants: the table
    (``models.attention.decode_page_table``) must cover EXACTLY the mask
    support — every stored block-column of the mask BCSR appears exactly
    once among the row's live slots, in ascending order (the
    sequential-fold bitwise contract), with dead slots only in the tail
    — and the placement (``serve.paged_kv.page_placement``) must respect
    the device page budget.  Returns human-readable error strings."""
    from repro_torch.models import attention as A
    from repro_torch.serve import paged_kv as PK
    pages, live, meta = A.decode_page_table(mask, seq_len, tuple(block))
    a = A.attention_mask_bcsr(mask, seq_len, tuple(block))
    errs = []
    nbr, nbc = meta.n_block_rows, meta.n_block_cols
    if pages.shape != live.shape or \
            pages.shape != (nbr, max(meta.max_bpr, 1)):
        errs.append(f"page-table shape {pages.shape} != "
                    f"({nbr}, {max(meta.max_bpr, 1)})")
        return errs
    if pages.size and (pages.min() < 0 or pages.max() >= nbc):
        errs.append(f"page id out of range [0, {nbc})")
    for i in range(nbr):
        want = np.sort(a.col_ids[a.row_ids == i]).tolist()
        got = pages[i][live[i]].tolist()
        if got != want:
            errs.append(f"row {i}: live pages {got} != mask support {want}"
                        " (coverage must be exact — no gaps, no extras)")
        count = int(live[i].sum())
        if live[i][:count].sum() != count:
            errs.append(f"row {i}: dead slots not a tail suffix")
    pspec = PK.PagePlacementSpec(resident_pages=resident_pages)
    resident = PK.page_placement(mask, seq_len, tuple(block), pspec)
    budget = nbc if resident_pages is None else \
        max(0, min(nbc, int(resident_pages)))
    if resident.size != nbc:
        errs.append(f"placement size {resident.size} != n_pages {nbc}")
    if int(resident.sum()) > budget:
        errs.append(f"resident-budget overflow: {int(resident.sum())} "
                    f"pages resident > budget {budget}")
    return errs


def verify_summary(meta, n: int, op: str = "spmm") -> dict:
    """Compact dict for a dry-run report: meta invariants (and, for
    sharded metas, per-shard checks) re-proved at report time."""
    if hasattr(meta, "shard_metas"):
        errs = verify_sharded_meta(meta)
        checked = f"sharded_meta[{meta.n_shards}]"
    else:
        errs = verify_meta(meta)
        checked = "meta"
    return {"ok": not errs, "checked": checked, "op": op, "n": n,
            "errors": list(errs)}


# ------------------------------------------------------------ structure zoo
@dataclasses.dataclass
class ZooCase:
    """One realized structure: the meta plus the sorted host entry list
    the schedules are built from, and which families apply to it."""
    name: str
    meta: object
    row_ids: np.ndarray
    col_ids: np.ndarray
    families: tuple


ZOO_MASKS = (("mask_banded", "banded", (32,), 128),
             ("mask_local_global", "local_global", (32, 16), 128),
             ("mask_causal", "blockwise_causal", (), 64))


def _zoo_masks():
    from repro_torch.core import attention_mask as AM
    for mname, kind, args, seq in ZOO_MASKS:
        yield mname, getattr(AM, kind)(*args), seq


def structure_zoo():
    """The metas the CLI runs the verifier over, from every producer of
    the port, with the JAX package's case names and host arrays:
    ``ops._prepare_sparse_host`` on random/ragged/reordered structures,
    ``attention_mask_meta`` for each mask family, the partitioned path
    (``dist_spmm._prepare_sharded_host``), and the sparse-linear weight
    pattern (``sparse_linear._pattern_for``).  Yields ``ZooCase``s (host
    numpy only -- cheap)."""
    from repro_torch.core import bcsr as bcsr_lib
    from repro_torch.core import sparse_linear as SL
    from repro_torch.kernels import ops
    from repro_torch.launch import dist_spmm
    from repro_torch.models import attention as A

    def prepared(name, a, families=("spmm", "sddmm"), **kw):
        host, meta = ops._prepare_sparse_host(
            a, reorder=kw.pop("reorder", "identity"),
            reorder_granularity=kw.pop("granularity", "element"),
            tau=0.7, max_candidates=None, n_shards=kw.pop("n_shards", 1))
        return ZooCase(name, meta, host["row_ids"], host["col_ids"],
                       tuple(families))

    yield prepared("rand_uniform_256",
                   bcsr_lib.random_bcsr_exact(0, (256, 256), (16, 16), 64))
    yield prepared("rand_ragged_250x200",
                   bcsr_lib.random_bcsr_exact(1, (250, 200), (16, 16), 40))
    yield prepared("rand_wide_block_32x16",
                   bcsr_lib.random_bcsr_exact(2, (256, 256), (32, 16), 32))
    skew = bcsr_lib.random_bcsr(3, (256, 256), (16, 16), 0.15,
                                fill_density=0.5)
    yield prepared("rand_skew_identity", skew)
    yield prepared("rand_skew_jaccard", skew, reorder="jaccard")

    for mname, spec, seq in _zoo_masks():
        a = A.attention_mask_bcsr(spec, seq, (16, 16))
        meta = A.attention_mask_meta(spec, seq, (16, 16))
        yield ZooCase(mname, meta, a.row_ids, a.col_ids,
                      ("spmm", "sddmm", "attn"))

    a = bcsr_lib.random_bcsr_exact(7, (320, 256), (16, 16), 80)
    host, smeta = dist_spmm._prepare_sharded_host(a, 4)
    yield ZooCase("sharded_4", smeta, host["row_ids"], host["col_ids"],
                  ("spmm", "sddmm"))
    # over-budgeted shards: leftover slots pad (row 0, col 0) with
    # DUPLICATE entries, so shard-local max_bpr can exceed n_block_cols —
    # the dims-derived budgets of the model-weight path hit this
    host, smeta = dist_spmm._prepare_sharded_host(a, 4, nnzb_per_shard=60)
    yield ZooCase("sharded_4_padded", smeta, host["row_ids"],
                  host["col_ids"], ("spmm", "sddmm"))

    spec = SL.SparsitySpec(density=0.3, block=(16, 16))
    pat = SL._pattern_for(11, 96, 64, spec)
    yield prepared("linear_d30_64x96", pat, granularity="block_row")


def run_verify(vmem_budget: int = workspace.H100_SMEM_PER_CTA,
               n_values=(64, 512), head_dims=(64, 128)) -> list:
    """The CLI pass: prove every zoo meta's invariants and every
    applicable schedule's contracts, plus grid and shared-memory
    feasibility at a few N values on both kernel backends (B1/B2 streamed,
    B3/B4 scheduled) and, for the masks, B5 at the head widths
    ``head_dims`` (B5 holds d <= 256, where the JAX package checks its
    fused kernel at the N values).  Returns ``Finding``s (empty = the
    tree's structural contracts hold)."""
    from repro_torch.launch.dist_spmm import chunk_schedule
    findings = []

    def emit(case, msgs):
        findings.extend(Finding("launch-verify", f"zoo:{case.name}", 0, m)
                        for m in msgs)

    for case in structure_zoo():
        if hasattr(case.meta, "shard_metas"):
            emit(case, verify_sharded_meta(case.meta))
            metas = list(zip(case.meta.shard_metas,
                             case.row_ids, case.col_ids))
        else:
            emit(case, verify_meta(case.meta))
            metas = [(case.meta, case.row_ids, case.col_ids)]
        for m, rows, cols in metas:
            for family in case.families:
                sched = build_schedule(family, rows, cols, m)
                emit(case, verify_schedule(family, sched[0], sched[1],
                                           rows, cols, m, row_len=sched[2]))
                if family == "attn":
                    for d in head_dims:
                        emit(case, verify_launch(m, "fused", n=d, op="attn",
                                                 vmem_budget=vmem_budget))
                    continue
                for backend in ("nnz_stream", "row_loop"):
                    for n in n_values:
                        emit(case, verify_launch(
                            m, backend, n=n, op=family,
                            vmem_budget=vmem_budget))
        # overlap chunk schedules: the chunked product equals the single
        # panel only if every (n, n_chunks) schedule partitions it exactly
        blk = (case.meta.shard_metas[0].block
               if hasattr(case.meta, "shard_metas") else case.meta.block)
        for n in n_values:
            for k in (1, 2, 4):
                emit(case, [f"chunk schedule n={n} k={k}: {e}"
                            for e in verify_chunk_schedule(
                                chunk_schedule(n, k), n, block=blk,
                                vmem_budget=vmem_budget)])

    # paged-KV page tables: exact mask-support coverage + placement
    # budgets, per mask family, with and without an offload budget
    for mname, spec, seq in _zoo_masks():
        for budget in (None, 2):
            findings.extend(
                Finding("launch-verify", f"paged:{mname}", 0, m)
                for m in verify_page_table(spec, seq, (16, 16),
                                           resident_pages=budget))
    return findings


# ------------------------------------------------------ Hopper resources
_RES_FUNCTION = re.compile(r"^\s*Function\s+(\S+?):?\s*$")
_RES_FIELD = re.compile(r"\b(REG|STACK|SHARED|LOCAL):(\d+)")
_SPMM_NAME = re.compile(
    r"spmm_kernelI.*?(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELb([01])E")
_SDDMM_NAME = re.compile(r"sddmm_kernelI.*?(13__nv_bfloat16|f)Lb([01])ELb([01])E")


def parse_res_usage(text: str) -> dict:
    """``{mangled function: {"REG", "STACK", "SHARED", "LOCAL": int}}`` from
    the output of ``cuobjdump -res-usage``: each ``Function <name>:`` line
    followed by its ``REG:.. STACK:.. SHARED:.. LOCAL:..`` line.  For
    ``sm_90a`` code ``SHARED`` counts the function's static shared memory
    plus the 1 KB the driver reserves a CTA (``static_smem``)."""
    out, fn = {}, None
    for line in text.splitlines():
        m = _RES_FUNCTION.match(line)
        if m:
            fn = m.group(1)
            continue
        fields = dict(_RES_FIELD.findall(line))
        if fn is not None and "REG" in fields:
            out[fn] = {k: int(fields.get(k, 0))
                       for k in ("REG", "STACK", "SHARED", "LOCAL")}
            fn = None
    return out


def resource_usage(library_path, cuobjdump: Optional[str] = None) -> dict:
    """``parse_res_usage`` of ``cuobjdump -res-usage <library_path>``: the
    registers, stack, static shared memory and local memory of every
    function compiled into a built kernel library.  ``cuobjdump`` defaults
    to the one beside ``nvcc`` (the card's machine only)."""
    if cuobjdump is None:
        from repro_torch.kernels import _build
        cuobjdump = str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-res-usage", str(library_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return parse_res_usage(text)


def instantiation(name: str) -> Optional[dict]:
    """What a mangled kernel name instantiates: ``{"family": "spmm",
    "dtype", "bm", "bn", "kmajor"}`` (B1/B3's ``spmm_kernel<Source, T, BM,
    BN, KMAJ>``), ``{"family": "sddmm", "dtype", "ak", "bk"}`` (B2/B4's
    ``sddmm_kernel<Source, T, AK, BK>``), ``{"family": "attn"}`` (B5), or
    None for another function."""
    def dtype(code):
        return "bfloat16" if code == "13__nv_bfloat16" else "float32"
    m = _SPMM_NAME.search(name)
    if m:
        return {"family": "spmm", "dtype": dtype(m.group(1)),
                "bm": int(m.group(2)), "bn": int(m.group(3)),
                "kmajor": m.group(4) == "1"}
    m = _SDDMM_NAME.search(name)
    if m:
        return {"family": "sddmm", "dtype": dtype(m.group(1)),
                "ak": m.group(2) == "1", "bk": m.group(3) == "1"}
    if "attn_fused_kernel" in name:
        return {"family": "attn"}
    return None


def static_smem(usage: dict) -> int:
    """A function's static shared memory: ``cuobjdump``'s ``SHARED`` less
    the ``H100_SMEM_RESERVED_PER_CTA`` it counts (1,024 B with no static
    array: B2/B4's reading on the card)."""
    return max(usage["SHARED"] - workspace.H100_SMEM_RESERVED_PER_CTA, 0)


def verify_resources(usage: dict, threads: int, dynamic_smem: int, *,
                     min_ctas: int = 1, what: str = ""):
    """Hold one compiled function's resources (a ``parse_res_usage``
    entry) to the H100's limits for a launch of ``threads`` threads and
    ``dynamic_smem`` bytes of dynamic shared memory: registers a thread
    <= 255; registers a CTA (``REG * threads``) <= 65,536; the
    ``__launch_bounds__`` minimum of ``min_ctas`` CTAs an SM (registers
    <= 65,536 / (threads * min_ctas), and that many CTAs fit); static +
    dynamic shared memory <= 232,448 bytes.  Returns ``(errors,
    ctas_per_sm)``."""
    regs, static = usage["REG"], static_smem(usage)
    smem = static + dynamic_smem
    errs = []
    if regs > workspace.H100_MAX_REGS_PER_THREAD:
        errs.append(f"{what}: {regs} registers a thread > "
                    f"{workspace.H100_MAX_REGS_PER_THREAD}")
    if regs * threads > workspace.H100_REGS_PER_SM:
        errs.append(f"{what}: {regs} registers x {threads} threads = "
                    f"{regs * threads} > the SM's "
                    f"{workspace.H100_REGS_PER_SM}: the launch is refused")
    cap = workspace.H100_REGS_PER_SM // (threads * min_ctas)
    if min_ctas > 1 and regs > cap:
        errs.append(f"{what}: {regs} registers a thread > {cap}, the most "
                    f"that __launch_bounds__({threads}, {min_ctas}) allows")
    if smem > workspace.H100_SMEM_PER_CTA:
        errs.append(f"{what}: {static} B static + {dynamic_smem} B dynamic "
                    f"shared memory > {workspace.H100_SMEM_PER_CTA} B a CTA")
    ctas = workspace.ctas_per_sm(threads, regs, smem)
    if ctas < min_ctas:
        errs.append(f"{what}: {ctas} CTA(s) an SM, fewer than the "
                    f"{min_ctas} its __launch_bounds__ asks")
    return errs, ctas


def verify_library_resources(usage: dict, *, attn_shape=(128, 128, 1)):
    """``verify_resources`` over every kernel in one library's
    ``resource_usage``, each at its own launch: B1/B3 at its (type, BM,
    BN, staging) with ``spmm_smem_bytes`` and ``spmm_threads(BM)``; B2/B4
    at ``sddmm_smem_bytes`` with 128 threads and ``__launch_bounds__``'s
    4 CTAs; B5 at ``attn_shape = (d, h, max_bpr)`` with its 256 threads at
    most.  Each function's static shared memory must also be the one the
    launch verifier counts (``workspace.SPMM_STATIC_SMEM``,
    ``SDDMM_STATIC_SMEM``, ``ATTN_STATIC_SMEM``).  Returns ``(rows,
    errors)``: one row per kernel function (its instantiation, ``regs``,
    ``static_smem``, ``local``, ``smem`` (dynamic), ``threads``,
    ``ctas_per_sm``)."""
    statics = {"spmm": workspace.SPMM_STATIC_SMEM,
               "sddmm": workspace.SDDMM_STATIC_SMEM,
               "attn": workspace.ATTN_STATIC_SMEM}
    rows, errs = [], []
    for name, use in sorted(usage.items()):
        inst = instantiation(name)
        if inst is None:
            continue
        min_ctas = 1
        if inst["family"] == "spmm":
            threads = workspace.spmm_threads(inst["bm"])
            smem = workspace.spmm_smem_bytes(inst["dtype"], inst["bm"],
                                             inst["bn"], inst["kmajor"])
        elif inst["family"] == "sddmm":
            threads, min_ctas = (workspace.SDDMM_THREADS,
                                 workspace.SDDMM_MIN_CTAS)
            smem = workspace.sddmm_smem_bytes(inst["dtype"], inst["ak"],
                                              inst["bk"])
        else:
            d, h, max_bpr = attn_shape
            threads = workspace.attn_threads(h)
            smem = workspace.attn_smem_bytes(d, h, max_bpr)
        e, ctas = verify_resources(use, threads, smem, min_ctas=min_ctas,
                                   what=name)
        if static_smem(use) != statics[inst["family"]]:
            e.append(f"{name}: {static_smem(use)} B of static shared "
                     f"memory, the verifier counts "
                     f"{statics[inst['family']]} B")
        errs += e
        rows.append({"function": name, **inst, "regs": use["REG"],
                     "static_smem": static_smem(use), "local": use["LOCAL"],
                     "smem": smem, "threads": threads,
                     "ctas_per_sm": ctas})
    return rows, errs
