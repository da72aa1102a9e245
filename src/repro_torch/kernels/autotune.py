"""Kernel-variant registry + autotuned SpMM/SDDMM dispatch.

SMaT's speedups come from matching the kernel schedule and tile to the
matrix's block structure.  This module is the JAX package's
``repro.kernels.autotune`` on the card:

  * a **registry** of kernel variants per compute family (``spmm``:
    nnz_stream / row_loop / xla / dense; ``sddmm``: the same four;
    ``attn``: fused (kernel B5) / composed (the SDDMM and SpMM kernels),
    resolved by ``models.attention.resolve_attn_impl``), each with its
    N-tile candidates -- the tiles its CUDA kernel compiles
    (``ops.kernel_tiles``), 0 for a backend without one -- and its dispatch
    constraints.  Only the hand-written kernels (``KernelVariant.is_kernel``)
    are ever picked; ``xla`` (the plain version) and ``dense`` (cuBLAS) are
    yardsticks that ``tune`` times beside them;
  * a **fingerprint** of an operand's structure (nnzb, padding, skew,
    block shape, N bucket, reorder, ``max_bpr``, ...), the cache key.  Its
    key is the JAX package's v7 key with ``|dev=<device name or cpu>``
    appended, so a pick measured on one device never serves another;
  * an **autotuner** that, per fingerprint, either takes the paper's
    performance model (``core.perf_model``, Eq. 1 with the H100 block
    roofline) for an analytic pick, or runs a timed sweep over the
    registered candidates on the device; decisions are cached in memory and
    mirrored to a JSON file (``REPRO_TORCH_AUTOTUNE_CACHE``; never the JAX
    package's file, which its ``save`` rewrites whole).

``ops.spmm(..., backend="auto")`` resolves through ``get_autotuner().pick``,
so ``auto`` always launches a kernel; explicit ``tune()`` calls run the
measured sweep.  ``tune`` skips only the candidates whose
``supported(meta)`` is False: any other failure of a candidate (a kernel
that does not build or launch) propagates.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import workspace
from repro_torch.core import bcsr as bcsr_lib
from repro_torch.core import perf_model as pm
from repro_torch.kernels import bcsr_spmm as pk
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

# the pre-registry default -- the baseline every pick must beat; bn 0 is
# "no explicit tile": the kernel takes its own (``bcsr_spmm.tile_n``)
DEFAULT_VARIANT = "nnz_stream"
DEFAULT_BN = 0
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

NO_TILE = (0,)           # the candidates of a backend with no N tile


# ------------------------------------------------------------------ registry
@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One dispatchable kernel schedule.

    ``op`` names the compute family (``"spmm"`` | ``"sddmm"`` | ``"attn"``
    -- picks never cross families); ``backend`` is the ``ops`` backend the
    variant lowers to; ``model_time`` maps (meta, n, bn) -> predicted
    seconds (paper Eq. 1 terms from ``core.perf_model``); ``supported``
    gates dispatch on static metadata (row_loop needs a known max_bpr).
    """
    name: str
    backend: str
    bn_candidates: Tuple[int, ...]
    model_time: Callable[[ops.SparseMeta, int, int], float]
    supported: Callable[[ops.SparseMeta], bool] = lambda meta: True
    description: str = ""
    op: str = "spmm"

    @property
    def is_kernel(self) -> bool:
        """True for a hand-written CUDA kernel: the only variants a pick
        dispatches.  The others are yardsticks ``tune`` times.  Both
        attention variants run kernels: B5, or the SDDMM and SpMM
        kernels."""
        return self.op == "attn" or bool(ops.kernel_tiles(self.backend,
                                                          self.op))


_REGISTRY: Dict[str, KernelVariant] = {}


def register_variant(v: KernelVariant) -> KernelVariant:
    if v.name in _REGISTRY:
        raise ValueError(f"variant {v.name!r} already registered")
    _REGISTRY[v.name] = v
    return v


def get_variant(name: str) -> KernelVariant:
    return _REGISTRY[name]


def variant_names(op: str = "spmm") -> Tuple[str, ...]:
    """Registered variant names of one compute family (``op=None`` lists
    every family)."""
    return tuple(n for n, v in _REGISTRY.items() if op is None or v.op == op)


def _bytes_per_el(dtype=torch.bfloat16) -> int:
    return torch.finfo(dtype).bits // 8


def _n_tiles(n: int, bn: int) -> int:
    return max(-(-n // bn), 1)  # the kernel covers N in bn-wide tiles


def _t_nnz_stream(meta: ops.SparseMeta, n: int, bn: int) -> float:
    h, w = meta.block
    return pm.spmm_model_time(meta.nnzb * _n_tiles(n, bn), h, w, bn)


def _t_row_loop(meta: ops.SparseMeta, n: int, bn: int) -> float:
    # the static schedule pays max_bpr slots on EVERY block-row (SMaT's dc2
    # worst case)
    h, w = meta.block
    n_e = meta.n_block_rows * max(meta.max_bpr, 1) * _n_tiles(n, bn)
    return pm.spmm_model_time(n_e, h, w, bn)


def _t_xla(meta: ops.SparseMeta, n: int, bn: int) -> float:
    # gather + einsum + index_add: streams every stored element with blocked
    # (coalesced) access -- modeled as CSR traffic at low overhead
    h, w = meta.block
    return pm.csr_spmm_time(meta.nnzb * h * w, n, gather_overhead=2.0)


def _t_dense(meta: ops.SparseMeta, n: int, bn: int) -> float:
    h, w = meta.block
    return pm.dense_gemm_time(meta.n_block_rows * h, meta.n_block_cols * w, n)


register_variant(KernelVariant(
    name="nnz_stream", backend="nnz_stream", bn_candidates=pk.SPMM_TILES,
    model_time=_t_nnz_stream,
    description="CUDA kernel streaming each block-row's entries "
                "(skew-immune)"))
register_variant(KernelVariant(
    name="row_loop", backend="row_loop", bn_candidates=pk.SPMM_TILES,
    model_time=_t_row_loop,
    supported=lambda meta: meta.max_bpr > 0,
    description="CUDA kernel of the paper's static 2D schedule (loop to "
                "max_bpr)"))
register_variant(KernelVariant(
    name="xla", backend="xla", bn_candidates=NO_TILE,
    model_time=_t_xla,
    description="plain PyTorch gather/index_add (the oracle path)"))
register_variant(KernelVariant(
    name="dense", backend="dense", bn_candidates=NO_TILE,
    model_time=_t_dense,
    description="materialized dense GEMM (cuBLAS arm; wins at high density)"))


# SDDMM family (ops.sddmm): X @ Y^T sampled at the stored blocks.  The
# contraction runs over N in the kernels' fixed chunk, so the per-block
# elementary cost is the SpMM block roofline with that chunk as the tile.
def _t_sddmm_stream(meta: ops.SparseMeta, n: int, bn: int) -> float:
    h, w = meta.block
    return pm.spmm_model_time(meta.nnzb * _n_tiles(n, bn), h, w, bn)


def _t_sddmm_row_loop(meta: ops.SparseMeta, n: int, bn: int) -> float:
    # static schedule: every (block-row, slot) pair pays its product, even
    # the padding slots that land in the sentinel output block.  That is
    # the JAX package's cost, kept so that the analytic picks follow its
    # model; on the card B4's padding slots only read their entry and exit,
    # and tune()'s measured sweep sees that
    h, w = meta.block
    n_e = meta.n_block_rows * max(meta.max_bpr, 1) * _n_tiles(n, bn)
    return pm.spmm_model_time(n_e, h, w, bn)


def _t_sddmm_xla(meta: ops.SparseMeta, n: int, bn: int) -> float:
    h, w = meta.block
    return pm.csr_spmm_time(meta.nnzb * h * w, n, gather_overhead=2.0)


def _t_sddmm_dense(meta: ops.SparseMeta, n: int, bn: int) -> float:
    # the full M x K product, then a block gather (charged as output reread)
    h, w = meta.block
    return pm.dense_gemm_time(meta.n_block_rows * h, n,
                              meta.n_block_cols * w)


register_variant(KernelVariant(
    name="sddmm_stream", backend="nnz_stream", op="sddmm",
    bn_candidates=pk.SDDMM_TILES, model_time=_t_sddmm_stream,
    description="CUDA SDDMM over the nonzero-block list (skew-immune)"))
register_variant(KernelVariant(
    name="sddmm_row_loop", backend="row_loop", op="sddmm",
    bn_candidates=pk.SDDMM_TILES, model_time=_t_sddmm_row_loop,
    supported=lambda meta: meta.max_bpr > 0,
    description="CUDA SDDMM of the static (block-row x slot) schedule"))
register_variant(KernelVariant(
    name="sddmm_xla", backend="xla", op="sddmm",
    bn_candidates=NO_TILE, model_time=_t_sddmm_xla,
    description="plain PyTorch gather/einsum SDDMM (the oracle path)"))
register_variant(KernelVariant(
    name="sddmm_dense", backend="dense", op="sddmm",
    bn_candidates=NO_TILE, model_time=_t_sddmm_dense,
    description="dense X Y^T + block gather (near-dense structures)"))


# Attention family (``models.attention.resolve_attn_impl`` under
# ``backend="auto"``): kernel B5, one launch of two passes, against the
# composed SDDMM -> softmax -> SpMM triple.  These are attention-level
# variants: their ``backend`` strings ("fused" / "composed") are resolved
# there, not by ``ops``.  B5 contracts over the whole head width and has no
# N tile; the composed model uses the SDDMM and SpMM kernels' own tiles.
_PEAK_3XTF32 = 495e12 / 3   # f32 products as three TF32 tensor-core ones


def _t_attn_fused(meta: ops.SparseMeta, n: int, bn: int) -> float:
    # one launch over each block-row's live slots (sentinel slots are
    # skipped): Q K^T twice (the row max, then the softmax sums) and z V
    # once, f32 operands on the tensor cores as 3xTF32
    h, w = meta.block
    return pm.spmm_model_time(3 * meta.nnzb, h, w, n, bytes_per_el=4,
                              peak_flops=_PEAK_3XTF32)


def _t_attn_composed(meta: ops.SparseMeta, n: int, bn: int) -> float:
    # streamed SDDMM + SpMM, plus the [nnzb,h,w] scores/probs tensors
    # crossing device memory twice each, plus two extra launch latencies
    h, w = meta.block
    t = (_t_sddmm_stream(meta, n, pk.SDDMM_TILES[0])
         + _t_nnz_stream(meta, n, pk.tile_n(n)))
    probs_bytes = 4.0 * meta.nnzb * h * w
    return t + 4.0 * probs_bytes / pm.HBM_BW + 2 * 5e-6


register_variant(KernelVariant(
    name="attn_fused", backend="fused", op="attn",
    bn_candidates=NO_TILE, model_time=_t_attn_fused,
    supported=lambda meta: meta.max_bpr > 0,
    description="CUDA kernel B5: SDDMM + block softmax + SpMM in one launch "
                "(two passes, no scores in device memory)"))
register_variant(KernelVariant(
    name="attn_composed", backend="composed", op="attn",
    bn_candidates=NO_TILE, model_time=_t_attn_composed,
    description="three dispatches: the SDDMM kernel, block softmax, the "
                "SpMM kernel (materializes scores/probs)"))


# --------------------------------------------------------------- fingerprint
def _pow2_bucket(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 0 else 0


def device_name(device) -> str:
    """The fingerprint's device field: ``"cpu"``, or the card's name
    (``torch.cuda.get_device_name``).  Raises for a CUDA device on a
    machine without one."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"no kernels for device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "explicitly to tune or pick on the CPU")
    return torch.cuda.get_device_name(device)


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """Structure stats that determine the best (variant, bn) -- the cache
    key.  The fields up to ``n_chunks`` are the JAX package's v7
    fingerprint (continuous stats bucketed: pad to 10%, skew to 25%, N to
    the next power of two; ``reorder``, ``n_shards``, the exact
    ``max_bpr``, the family ``op`` and the overlap depth ``n_chunks`` keep
    picks of different structures, families and execution contexts apart).
    ``device`` is the port's: the device the pick is for, so a CPU-measured
    pick never serves the card."""
    n_block_rows: int
    n_block_cols: int
    block: Tuple[int, int]
    nnzb: int
    pad_bucket: int      # padding_ratio in 10% buckets
    skew_bucket: int     # blocks-per-row cv in 25% buckets
    n_bucket: int        # next pow2 of N
    reorder: str = "identity"
    n_shards: int = 1    # shard count of the partitioned operand (1 = whole)
    max_bpr: int = 0     # row_loop schedule bound (0 = unknown/dims-only)
    op: str = "spmm"     # compute family (spmm | sddmm | attn)
    n_chunks: int = 1    # B-panel overlap chunks (shard-count key axis)
    device: str = "cpu"  # device name (``device_name``)

    def key(self) -> str:
        """The JAX package's v7 key with ``|dev=<device>`` appended
        (``analysis.fingerprint_audit.parse_key`` inverts it).  A device
        name that could not be parsed back -- empty, or holding ``|`` --
        raises."""
        if not self.device or "|" in self.device:
            raise ValueError(
                f"device name {self.device!r} cannot be keyed: a "
                "fingerprint's device must be non-empty and hold no '|'")
        h, w = self.block
        return (f"v7|op={self.op}"
                f"|nbr={self.n_block_rows}|nbc={self.n_block_cols}"
                f"|b={h}x{w}|nnzb={self.nnzb}|pad={self.pad_bucket}"
                f"|skew={self.skew_bucket}|n={self.n_bucket}"
                f"|ro={self.reorder}|ns={self.n_shards}|mb={self.max_bpr}"
                f"|nk={self.n_chunks}|dev={self.device}")


def _make_fingerprint(nbr: int, nbc: int, block, nnzb: int,
                      pad_pct: int, cv_pct: int, n: int,
                      reorder: str = "identity",
                      n_shards: int = 1, max_bpr: int = 0,
                      op: str = "spmm", n_chunks: int = 1,
                      device: str = "cpu") -> Fingerprint:
    """Single bucketing site for both fingerprint paths -- the meta-side and
    BCSR-side keys must agree bit for bit or cached picks stop matching."""
    return Fingerprint(
        n_block_rows=nbr, n_block_cols=nbc, block=tuple(block), nnzb=nnzb,
        pad_bucket=pad_pct // 10, skew_bucket=cv_pct // 25,
        n_bucket=_pow2_bucket(n), reorder=reorder, n_shards=n_shards,
        max_bpr=max_bpr, op=op, n_chunks=n_chunks, device=device)


def fingerprint(meta: ops.SparseMeta, n: int, op: str = "spmm",
                n_chunks: int = 1, device: str = "cpu") -> Fingerprint:
    """Fingerprint from the static meta ``ops.prepare`` built.  ``device``
    is a device name (``device_name``)."""
    return _make_fingerprint(meta.n_block_rows, meta.n_block_cols,
                             meta.block, meta.nnzb,
                             meta.padding_ratio_pct, meta.bpr_cv_pct, n,
                             reorder=meta.reorder, n_shards=meta.n_shards,
                             max_bpr=meta.max_bpr, op=op, n_chunks=n_chunks,
                             device=device)


def fingerprint_bcsr(a: bcsr_lib.BCSR, n: int, reorder: str = "identity",
                     op: str = "spmm", device: str = "cpu") -> Fingerprint:
    """Fingerprint from a host BCSR -- equal to ``fingerprint`` of the meta
    ``ops.prepare`` would build (same row padding first).  ``reorder``
    names the scheme that PRODUCED this matrix's structure; the matrix is
    not re-permuted here."""
    a_p = a.ensure_nonempty_rows()
    max_bpr, pad_pct, cv_pct = a_p.dispatch_stats()
    return _make_fingerprint(a_p.n_block_rows, a_p.n_block_cols, a_p.block,
                             a_p.nnzb, pad_pct, cv_pct, n, reorder=reorder,
                             max_bpr=max_bpr, op=op, device=device)


# -------------------------------------------------------------------- choice
@dataclasses.dataclass(frozen=True)
class KernelChoice:
    variant: str
    bn: int
    source: str = "analytic"    # analytic | measured | default
    predicted_us: float = 0.0

    @property
    def backend(self) -> str:
        return get_variant(self.variant).backend

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "KernelChoice":
        return KernelChoice(variant=d["variant"], bn=int(d["bn"]),
                            source=d.get("source", "analytic"),
                            predicted_us=float(d.get("predicted_us", 0.0)))


def default_variant(op: str = "spmm") -> str:
    """The pre-registry default of one compute family -- the baseline every
    pick must beat.  For ``attn`` that is the composed triple."""
    if op == "attn":
        return "attn_composed"
    return DEFAULT_VARIANT if op == "spmm" else "sddmm_stream"


def default_choice(op: str = "spmm") -> KernelChoice:
    return KernelChoice(default_variant(op), DEFAULT_BN, source="default")


_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def tile_fits(meta: ops.SparseMeta, n: int, bn: int) -> bool:
    """True iff the CTA of an N tile ``bn`` fits one CTA's shared memory on
    the H100, in either type and either staging of B.  A tile of
    ``bcsr_spmm.SPMM_TILES`` is budgeted as the B1/B3 launch runs it: at
    the row block ``bcsr_spmm.spmm_row_block`` picks for (N, h),
    ``workspace.spmm_smem_bytes`` plus the static entry-id window; "no
    tile" (0) always fits."""
    if bn not in pk.SPMM_TILES:
        return True
    bm = pk.spmm_row_block(n, meta.block[0])
    smem = max(workspace.spmm_smem_bytes(dt, bm, bn, km)
               for dt in _KERNEL_DTYPES for km in (True, False)) + \
        workspace.SPMM_STATIC_SMEM
    return smem <= workspace.H100_SMEM_PER_CTA


def pick_bn(meta: ops.SparseMeta, n: int,
            candidates: Iterable[int]) -> int:
    """Largest candidate whose CTA fits one CTA's shared memory
    (``tile_fits``: the CUDA kernels' own budget, not the JAX package's
    VMEM cell, ``workspace.fits_vmem``) and is no wider than N needs."""
    candidates = tuple(candidates)
    feasible = [bn for bn in candidates if tile_fits(meta, n, bn)]
    if not feasible:
        feasible = [min(candidates)]
    # no point tiling wider than N
    fit_n = [bn for bn in feasible if bn <= max(n, min(feasible))]
    return max(fit_n or feasible)


PICK_OPS = ops.OPS + ("attn",)


def _check_op(op: str) -> None:
    if op not in PICK_OPS:
        raise ValueError(f"unknown kernel family {op!r}; picks take one of "
                         f"{PICK_OPS}")


def analytic_choice(meta: ops.SparseMeta, n: int,
                    op: str = "spmm") -> KernelChoice:
    """Model-based pick: paper Eq. 1 per kernel variant of the ``op``
    family, minimum predicted time."""
    _check_op(op)
    best: Optional[Tuple[float, str, int]] = None
    for v in _REGISTRY.values():
        if v.op != op or not v.is_kernel or not v.supported(meta):
            continue
        bn = pick_bn(meta, n, v.bn_candidates)
        t = float(v.model_time(meta, n, bn))
        if best is None or t < best[0]:
            best = (t, v.name, bn)
    if best is None:  # every variant gated off -- keep the default
        return default_choice(op)
    t, name, bn = best
    return KernelChoice(name, bn, source="analytic", predicted_us=t * 1e6)


# ----------------------------------------------------------- shard-count axis
# Candidate shard counts of the partitioned path (``launch.dist_spmm``:
# ``resolve_n_shards`` reads the pick, ``tune_shard_count`` measures it);
# 1 = one shard.  A partitioned operand's per-shard metas carry
# ``n_shards``, so ``pick`` and ``tune`` key each shard's kernel apart.
SHARD_CANDIDATES = (1, 2, 4, 8)

_T_INIT = 5e-6        # per-launch latency (matches pm.spmm_model_time)
_T_SHARD_SYNC = 5e-7  # cross-shard coordination cost per shard doubling


@dataclasses.dataclass(frozen=True)
class ShardChoice:
    """A cached shard-count decision (the S analogue of KernelChoice)."""
    n_shards: int
    source: str = "analytic"    # analytic | measured
    predicted_us: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ShardChoice":
        return ShardChoice(n_shards=int(d["n_shards"]),
                           source=d.get("source", "analytic"),
                           predicted_us=float(d.get("predicted_us", 0.0)))


def shard_candidates(max_shards: int, n_block_rows: int) -> Tuple[int, ...]:
    """The S values ``pick_shards`` considers: ``SHARD_CANDIDATES`` capped
    by the device count AND the block-row count."""
    cap = max(min(int(max_shards), max(int(n_block_rows), 1)), 1)
    cands = tuple(s for s in SHARD_CANDIDATES if s <= cap)
    return cands or (1,)


def _pipeline_time(t_comp: float, t_coll: float, n_chunks: int) -> float:
    """Total time of a ``k``-stage software pipeline that issues the
    collective for chunk ``i+1`` before the product over chunk ``i``."""
    k = max(int(n_chunks), 1)
    return t_coll / k + t_comp / k + (k - 1) / k * max(t_comp, t_coll)


def analytic_shard_choice(meta: ops.SparseMeta, n: int, *,
                          max_shards: int = 8, n_chunks: int = 1,
                          op: str = "spmm") -> ShardChoice:
    """Model-based shard count for the partitioned path: S=1 is plain Eq. 1;
    for S>1 the per-shard work is the balanced load, B crosses NVLink once
    (``pm.NVLINK_BW``, one direction), and the two legs compose through the
    ``n_chunks``-deep overlap pipeline.  Ties go to the smaller S."""
    h, w = meta.block
    nbr = max(meta.n_block_rows, 1)
    bn = pick_bn(meta, n, get_variant(default_variant("spmm")).bn_candidates)
    tiles = _n_tiles(n, bn)
    _, _, t_e = pm.block_mma_time(h, w, bn)
    t_coll = float(meta.shape[1]) * n * _bytes_per_el() / pm.NVLINK_BW
    best: Optional[Tuple[float, int]] = None
    for s in shard_candidates(max_shards, nbr):
        if s == 1:
            t = pm.spmm_model_time(meta.nnzb * tiles, h, w, bn)
        else:
            load = -(-meta.nnzb // s) + -(-nbr // s)
            t_comp = t_e * load * tiles
            t = (_T_INIT + _T_SHARD_SYNC * (s.bit_length() - 1)
                 + _pipeline_time(t_comp, t_coll, n_chunks))
        if best is None or t < best[0]:
            best = (t, s)
    t, s = best
    return ShardChoice(s, source="analytic", predicted_us=t * 1e6)


def shard_entry_key(fp: Fingerprint, max_shards: int) -> str:
    """Cache key of a shard-count decision: the device cap prefixed onto
    the structure's fingerprint key."""
    return f"shards|max={int(max_shards)}|{fp.key()}"


# ----------------------------------------------------------------- autotuner
def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_once(fn, device: torch.device) -> float:
    """Seconds one call of ``fn`` takes on ``device``: CUDA events around
    it on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


class Autotuner:
    """Fingerprint -> KernelChoice cache with analytic and measured fills.

    ``cache_path`` (or ``REPRO_TORCH_AUTOTUNE_CACHE``: a writable
    ``<path>.json`` shares tuned picks across processes, e.g. from an
    offline sweep into a serving process) mirrors the table to JSON;
    loading tolerates a missing or corrupt file (starts empty), saving is
    atomic (tmp + rename).  With neither set the cache is in memory only.

    A cache MISS never blocks dispatch: ``pick`` falls back to the analytic
    perf-model choice (paper Eq. 1).  Timed sweeps run only in ``tune()``.

    >>> from repro_torch.core import bcsr as bcsr_lib
    >>> from repro_torch.kernels import autotune, ops
    >>> a = bcsr_lib.random_bcsr_exact(0, (256, 256), (16, 16), nnzb=64)
    >>> meta = ops.prepare_sparse_meta(a)
    >>> tuner = autotune.Autotuner()          # in-memory (no cache file)
    >>> choice = tuner.pick(meta, n=128, device="cpu")
    >>> choice.variant in autotune.variant_names()
    True
    >>> tuner.pick(meta, n=128, device="cpu") is choice    # cached
    True
    """

    def __init__(self, cache_path: Optional[str] = None):
        self.cache_path = cache_path or os.environ.get(CACHE_ENV) or None
        self._mem: Dict[str, KernelChoice] = {}
        self._shards: Dict[str, ShardChoice] = {}
        if self.cache_path:
            self.load()

    # ------------------------------------------------------------- storage
    def load(self) -> None:
        try:
            with open(self.cache_path) as f:
                payload = json.load(f)
            for k, d in payload.get("entries", {}).items():
                # an entry naming a yardstick (or an unknown variant) is
                # not a pick: drop it
                v = _REGISTRY.get(d.get("variant"))
                if v is not None and v.is_kernel:
                    self._mem[k] = KernelChoice.from_dict(d)
            for k, d in payload.get("shard_entries", {}).items():
                self._shards[k] = ShardChoice.from_dict(d)
        except (OSError, ValueError, KeyError, AttributeError, TypeError):
            pass  # absent/corrupt/wrong-shape cache -> start empty

    def save(self) -> None:
        if not self.cache_path:
            return
        payload = {"version": 1,
                   "entries": {k: c.to_dict() for k, c in self._mem.items()},
                   "shard_entries": {k: c.to_dict()
                                     for k, c in self._shards.items()}}
        tmp = f"{self.cache_path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(os.path.abspath(self.cache_path)),
                        exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.cache_path)
        except OSError:
            pass  # read-only file system: the in-memory cache still works

    # -------------------------------------------------------------- lookup
    def get(self, fp: Fingerprint) -> Optional[KernelChoice]:
        return self._mem.get(fp.key())

    def put(self, fp: Fingerprint, choice: KernelChoice,
            persist: bool = True) -> None:
        if not get_variant(choice.variant).is_kernel:
            raise ValueError(f"{choice.variant!r} is a yardstick, not a "
                             "kernel a pick may dispatch")
        self._mem[fp.key()] = choice
        if persist:
            self.save()

    def get_shards(self, fp: Fingerprint,
                   max_shards: int) -> Optional[ShardChoice]:
        return self._shards.get(shard_entry_key(fp, max_shards))

    def put_shards(self, fp: Fingerprint, max_shards: int,
                   choice: ShardChoice, persist: bool = True) -> None:
        self._shards[shard_entry_key(fp, max_shards)] = choice
        if persist:
            self.save()

    def pick_shards(self, meta: ops.SparseMeta, n: int, *,
                    max_shards: int = 8, n_chunks: int = 1,
                    op: str = "spmm", device="cuda") -> ShardChoice:
        """Cached shard count for this structure, analytic on a miss."""
        fp = fingerprint(meta, n, op=op, n_chunks=n_chunks,
                         device=device_name(device))
        hit = self.get_shards(fp, max_shards)
        if hit is not None:
            obs_trace.event("autotune.pick_shards", key=fp.key(),
                            max_shards=max_shards, n_shards=hit.n_shards,
                            source=hit.source, cache_hit=True)
            obs_metrics.counter("autotune.cache_hit", kind="shards").inc()
            return hit
        choice = analytic_shard_choice(meta, n, max_shards=max_shards,
                                       n_chunks=n_chunks, op=op)
        self._shards[shard_entry_key(fp, max_shards)] = choice
        obs_trace.event("autotune.pick_shards", key=fp.key(),
                        max_shards=max_shards, n_shards=choice.n_shards,
                        source=choice.source, cache_hit=False)
        obs_metrics.counter("autotune.cache_miss", kind="shards").inc()
        return choice

    def __len__(self) -> int:
        return len(self._mem)

    def pick(self, meta: ops.SparseMeta, n: int, op: str = "spmm",
             device="cuda") -> KernelChoice:
        """Cached choice for this structure on ``device``, analytic on a
        miss (cached in memory, not written to disk); always a kernel."""
        fp = fingerprint(meta, n, op=op, device=device_name(device))
        hit = self.get(fp)
        if hit is not None:
            obs_trace.event("autotune.pick", key=fp.key(), op=op,
                            variant=hit.variant, bn=hit.bn,
                            source=hit.source, cache_hit=True)
            obs_metrics.counter("autotune.cache_hit", op=op).inc()
            return hit
        choice = analytic_choice(meta, n, op=op)
        self.put(fp, choice, persist=False)
        obs_trace.event("autotune.pick", key=fp.key(), op=op,
                        variant=choice.variant, bn=choice.bn,
                        source=choice.source, cache_hit=False)
        obs_metrics.counter("autotune.cache_miss", op=op).inc()
        return choice

    # ------------------------------------------------------------- tuning
    def tune(self, a: bcsr_lib.BCSR, n: int, *, dtype=torch.float32,
             variants: Optional[Iterable[str]] = None,
             warmup: int = 1, iters: int = 3, rng_seed: int = 0,
             reorder: str = "identity",
             reorder_granularity: str = "element",
             n_shards: int = 8, op: str = "spmm", layout: str = "row_major",
             device="cuda") -> Tuple[KernelChoice, Dict[str, float]]:
        """Timed sweep over the ``op`` family's (variant, bn) candidates on
        ``device``.

        Always measures the family's default (``nnz_stream`` /
        ``sddmm_stream`` with the kernel's own tile) so the winner is never
        slower than it (ties within 2% go to the default); returns
        (choice, {candidate: seconds, the median of ``iters`` calls}).  The
        winner is the fastest kernel; the yardsticks (``xla``, ``dense``)
        are timed and reported in the timings, never picked.  It is cached
        (and persisted) under the matrix's fingerprint.

        The sweep times the traffic of the caller's path: ``reorder``
        mirrors the ``prepare`` arguments, and ``layout`` the dense
        operands.  ``"row_major"``: the timed call is ``ops.spmm(arrays,
        meta, b)`` with a contiguous ``b [K, n]``, or ``ops.sddmm(arrays,
        meta, x, y)`` with contiguous ``x [M, n]``, ``y [K, n]``.
        ``"token_major"``: each operand is the transposed view of a
        contiguous ``[n, rows]`` tensor, as ``apply_sparse_linear`` passes
        ``x^T`` and its backward passes ``dC`` and ``x^T`` to the SDDMM.
        The key does not hold the layout: tune a structure for the path
        that runs it.  A candidate whose ``supported(meta)`` is False is
        skipped; any failure of a candidate that runs propagates.
        """
        _check_op(op)
        if op == "attn":
            raise ValueError(
                "tune(op='attn'): there is no measured sweep of the attn "
                "family (the JAX package's tune has none either); its picks "
                "are analytic, and backend='fused' or an ops backend names "
                "the path explicitly")
        if layout not in ("row_major", "token_major"):
            raise ValueError(f"unknown layout {layout!r}; want 'row_major' "
                             "or 'token_major'")
        device = torch.device(device)
        dev_name = device_name(device)
        arrays, meta = ops.prepare(
            a, dtype, reorder=reorder,
            reorder_granularity=reorder_granularity, n_shards=n_shards,
            device=device)
        fp = fingerprint(meta, n, op=op, device=dev_name)
        rng = np.random.default_rng(rng_seed)

        def operand(rows):
            if layout == "token_major":
                return torch.from_numpy(rng.standard_normal((n, rows)).astype(
                    np.float32)).to(device, dtype).T
            return torch.from_numpy(rng.standard_normal((rows, n)).astype(
                np.float32)).to(device, dtype)
        if op == "sddmm":
            x, y = operand(meta.shape[0]), operand(meta.shape[1])

            def _mk_fn(backend, bn):
                return lambda: ops.sddmm(arrays, meta, x, y, backend=backend,
                                         bn=bn)
        else:
            b = operand(meta.shape[1])

            def _mk_fn(backend, bn):
                return lambda: ops.spmm(arrays, meta, b, backend=backend,
                                        bn=bn)

        names = tuple(variants) if variants else variant_names(op)
        cand: Dict[str, Tuple[str, int]] = {}
        for name in names:
            v = get_variant(name)
            if v.op != op or not v.supported(meta):
                continue
            bns = {pick_bn(meta, n, v.bn_candidates)}
            bns.update(bn for bn in v.bn_candidates
                       if bn <= max(n, min(v.bn_candidates)))
            for bn in sorted(bns):
                cand[f"{name}/bn{bn}"] = (name, bn)
        dv = default_variant(op)
        cand.setdefault(f"{dv}/bn{DEFAULT_BN}", (dv, DEFAULT_BN))

        timings: Dict[str, float] = {}
        with torch.inference_mode(), obs_trace.span(
                "autotune.tune", key=fp.key(), op=op,
                n_candidates=len(cand)):
            for label, (name, bn) in cand.items():
                fn = _mk_fn(get_variant(name).backend, bn)
                for _ in range(max(warmup, 1)):
                    fn()
                _sync(device)
                timings[label] = float(np.median(
                    [_time_once(fn, device) for _ in range(iters)]))

        default_label = f"{dv}/bn{DEFAULT_BN}"
        best_label = min((label for label, (name, _) in cand.items()
                          if get_variant(name).is_kernel), key=timings.get)
        # prefer the default on a tie within noise (2%)
        if timings[default_label] <= timings[best_label] * 1.02:
            best_label = default_label
        name, bn = cand[best_label]
        choice = KernelChoice(name, bn, source="measured",
                              predicted_us=timings[best_label] * 1e6)
        self.put(fp, choice, persist=True)
        obs_trace.event("autotune.tuned", key=fp.key(), op=op,
                        variant=choice.variant, bn=choice.bn,
                        n_candidates=len(timings))
        obs_metrics.counter("autotune.tuned", op=op).inc()
        return choice, timings


# ---------------------------------------------------------------- singleton
_DEFAULT_TUNER: Optional[Autotuner] = None


def get_autotuner() -> Autotuner:
    global _DEFAULT_TUNER
    if _DEFAULT_TUNER is None:
        _DEFAULT_TUNER = Autotuner()
    return _DEFAULT_TUNER


def set_autotuner(tuner: Optional[Autotuner]) -> None:
    """Swap the process-wide tuner (tests; serving with a shared cache)."""
    global _DEFAULT_TUNER
    _DEFAULT_TUNER = tuner
