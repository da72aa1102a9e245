"""Row permutations of a host BCSR: the block-densifying reorder, wired
end to end.

``core.reorder`` holds the paper's reference schemes (Section IV-C); its
greedy Jaccard clustering is an O(n^2) pure-Python loop.  This module makes
the permutation a preprocessing step of the pipeline:

  * ``jaccard_rows_fast`` -- the same greedy clustering over packed
    block-column bitmasks (a Jaccard distance is an AND + popcount).  With
    a C compiler the host kernel of ``core.native`` runs the exact
    reference single pass (bit-identical permutations); otherwise numpy
    scans candidates in batched rounds against the growing union.
  * ``SCHEMES`` -- THE dispatch table: every scheme is a callable
    ``fn(csr, *, block, tau, max_candidates, n_shards) -> row_perm`` (or
    ``(row_perm, col_perm)`` for the row+column ablation).
    ``reorder.reorder()`` and ``ops.prepare(reorder=...)`` both use it.
  * ``permute_bcsr`` -- applies a scheme to a host BCSR at two
    granularities: ``element`` re-blocks the row-permuted CSR (nnzb can
    shrink), ``block_row`` permutes whole block-rows (nnzb preserved: the
    model-weight path).

Every function returns exactly what the JAX package's
``repro.core.permute`` returns on the same inputs
(``tests/test_torch_reorder.py``).  ``kernels.ops`` stores ``row_perm`` /
``inv_perm`` beside the blocks and undoes the permutation on the way out
(C = P^T (A' B)), so every caller sees original row order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from repro_torch.core import bcsr as bcsr_lib
from repro_torch.core import native
from repro_torch.core.reorder import identity as _identity_rows
from repro_torch.core.reorder import rcm as _rcm_rows
from repro_torch.core.reorder import shard_balance as _shard_balance_brows

try:  # numpy >= 2.0
    _popcount = np.bitwise_count
except AttributeError:  # numpy 1.x
    _POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)

    def _popcount(x):
        flat = np.ascontiguousarray(x).view(np.uint8)
        return _POP8[flat].reshape(*x.shape, x.dtype.itemsize).sum(-1)


def _max_bcol(pc: np.ndarray) -> int:
    """Largest block-column set in a packed mask (-1 if empty).

    The uint64 view preserves ``packbits`` byte order, so byte k covers
    bcols [8k, 8k+8) with the byte's MSB = bcol 8k."""
    b = pc.view(np.uint8)
    nz = np.flatnonzero(b)
    if nz.size == 0:
        return -1
    k = int(nz[-1])
    v = int(b[k])
    return 8 * k + 7 - ((v & -v).bit_length() - 1)


def _row_popcount(masked: np.ndarray) -> np.ndarray:
    """Per-row popcount of a [R, W] uint64 array -> int64 [R].

    Manual column accumulation: ``uint8.sum(axis=1)`` goes through numpy's
    generic pairwise reduction, which costs ~7x more than W strided adds
    for the tiny W (2-16 words) these masks have."""
    c = _popcount(masked)
    if c.ndim == 1:
        return c.astype(np.int64)
    inter = c[:, 0].astype(np.int64)
    for w in range(1, c.shape[1]):
        inter += c[:, w]
    return inter


# ----------------------------------------------------------- packed patterns
def pack_block_patterns(csr: sp.csr_matrix, block_w: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row block-column sets as packed uint64 bitmasks.

    Returns (packed [n, n_words], popcount [n], first_block_col [n];
    -1 for empty rows).  One row of ``packed`` is the indicator of the
    row's nonzero block-columns — the set the greedy clustering works on.
    """
    n, m = csr.shape
    nbc = -(-m // block_w)
    n_words = max(-(-nbc // 64), 1)
    indptr = np.asarray(csr.indptr)
    lens = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    bcols = np.asarray(csr.indices, dtype=np.int64) // block_w
    # dense indicator -> packbits: one C pass, no ufunc.at scatter.  The
    # bcol -> bit mapping is packbits's big-endian byte order; every
    # consumer only ANDs/ORs/popcounts the masks, so any fixed bijection
    # is fine.
    ind = np.zeros((n, nbc), bool)
    ind[rows, bcols] = True
    packed8 = np.packbits(ind, axis=1)
    if packed8.shape[1] != n_words * 8:
        packed8 = np.pad(packed8,
                         ((0, 0), (0, n_words * 8 - packed8.shape[1])))
    packed = np.ascontiguousarray(packed8).view(np.uint64)
    pop = _row_popcount(packed)
    has = lens > 0
    if getattr(csr, "has_sorted_indices", False):
        first = np.full(n, -1, np.int64)
        first[has] = bcols[indptr[:-1][has]]   # min bcol: indices sorted
    else:
        first = np.where(has, ind.argmax(axis=1), -1).astype(np.int64)
    return packed, pop, first


# ------------------------------------------------------ vectorized clustering
def jaccard_rows_fast(csr: sp.csr_matrix, block_w: int = 128,
                      tau: float = 0.7,
                      max_candidates: Optional[int] = None) -> np.ndarray:
    """Greedy Jaccard row clustering on packed bitmasks (paper IV-C).

    Same greedy scheme as ``reorder.jaccard_rows``: open a cluster at the
    first unclustered row (rows pre-ordered by first block-column), merge
    every candidate whose Jaccard distance to the cluster's column-pattern
    union is below ``tau``, with ``max_candidates`` capping the scan window
    per cluster.  With the ``core.native`` kernel available, the reference
    single-pass greedy runs verbatim — permutations are bit-identical to
    ``reorder.jaccard_rows``.

    The numpy fallback replaces the reference's sequential growing-union
    pass with batched ROUNDS to a fixpoint (each round tests all remaining
    candidates against the current union, joins them together, repeats
    until nothing joins).  A candidate rejected mid-pass by the reference
    can therefore join in a later round here (and vice versa), so the
    fallback's clustering may differ slightly from the reference —
    typically reducing blocks as well or better; same tau/max_candidates
    meaning.  Within the rounds scheme these steps are exact (not
    heuristic):
      * the accept test is the cross-form ``inter > (1-tau)*union``
        (same predicate as ``1 - inter/union < tau``, no division);
      * union-growth rounds update intersections incrementally — only the
        words the union actually gained (``delta``) are re-popcounted, and
        a round where the union does not grow is a fixpoint;
      * candidates with ``pop <= (1-tau) * |union|`` are dropped
        permanently (they can never pass: inter <= pop and the union only
        grows).
    """
    n = csr.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    packed, pop, first = pack_block_patterns(csr, block_w)
    order = np.argsort(first, kind="stable").astype(np.int64)
    # native kernel (core.native): the exact reference single-pass greedy
    # over these bitmasks, compiled at first use; None without a toolchain
    native_perm = native.jaccard_cluster(
        np.ascontiguousarray(packed[order]), pop[order], tau,
        max_candidates)
    if native_perm is not None:
        return order[native_perm]
    # working copies in scan order.  Compaction is LAZY: clustered rows are
    # masked out via ``alive`` and the arrays are physically rebuilt only
    # once >40% of rows died — round 1 stays a contiguous slice op and the
    # O(R) copies happen ~log times total instead of once per cluster.
    rem_ids = order
    rem_packed = np.ascontiguousarray(packed[order])
    rem_pop = pop[order]
    rem_first = first[order]                   # nondecreasing
    alive = np.ones(n, bool)
    n_alive = n
    start = 0                   # first alive position
    perm = np.empty(n, np.int64)
    out = 0
    one_m_tau = 1.0 - tau
    while n_alive:
        if n_alive < 0.6 * rem_ids.size:        # compact
            rem_ids = rem_ids[alive]
            rem_packed = np.ascontiguousarray(rem_packed[alive])
            rem_pop = rem_pop[alive]
            rem_first = rem_first[alive]
            alive = np.ones(n_alive, bool)
            start = 0
        while not alive[start]:
            start += 1
        R = rem_ids.size
        pc = rem_packed[start].copy()
        pc_pop = int(rem_pop[start])
        perm[out] = rem_ids[start]
        out += 1
        alive[start] = False
        n_alive -= 1
        if max_candidates is None or max_candidates >= n_alive:
            cap_end = R
        else:                   # cap counts ALIVE candidates, like the ref
            cnt = np.cumsum(alive[start + 1:])
            cap_end = min(
                start + 2 + int(np.searchsorted(cnt, max_candidates)), R)
        # exact window bound: candidates are sorted by first block-col, so
        # anything whose first col exceeds the union's max col has empty
        # intersection (dist 1) and cannot join; the window re-extends when
        # the union grows
        scan_end = start + 1
        cand = np.arange(0)
        inter = c_pop = np.arange(0)
        live = np.zeros(0, bool)

        def _extend(scan_end, cand, inter, c_pop, live, pc, pc_pop):
            hi = int(np.searchsorted(rem_first, _max_bcol(pc), "right"))
            hi = max(min(cap_end, hi), scan_end)
            if hi > scan_end:
                ext = np.arange(scan_end, hi)
                # fresh candidates: full intersection against current pc
                # (one contiguous pass — dead rows are wasted AND lanes,
                # bounded by the 60% compaction threshold)
                inter = np.concatenate([
                    inter, _row_popcount(rem_packed[scan_end:hi] & pc)])
                cand = np.concatenate([cand, ext])
                c_pop = np.concatenate([c_pop, rem_pop[scan_end:hi]])
                live = np.concatenate([live, alive[scan_end:hi]])
            return hi, cand, inter, c_pop, live

        if pc_pop == 0:
            # empty-pattern seed: no column span, but empty candidates
            # (union == 0 -> dist 0) join when tau > 0; they sort first
            hi = int(np.searchsorted(rem_first, -1, "right"))
            hi = max(min(cap_end, hi), scan_end)
            cand = np.arange(scan_end, hi)
            inter = np.zeros(cand.size, np.int64)
            c_pop = rem_pop[scan_end:hi]
            live = alive[scan_end:hi].copy()
            scan_end = hi
        else:
            scan_end, cand, inter, c_pop, live = _extend(
                scan_end, cand, inter, c_pop, live, pc, pc_pop)
        while cand.size:
            union = c_pop + pc_pop - inter
            # dist < tau  <=>  inter > (1-tau) * union, with the union==0
            # corner (both patterns empty -> dist 0) accepted when tau > 0
            accept = inter > one_m_tau * union
            if pc_pop == 0 and tau > 0:
                accept |= union == 0
            accept &= live
            if not accept.any():
                break
            jpos = cand[accept]
            perm[out:out + jpos.size] = rem_ids[jpos]
            out += jpos.size
            alive[jpos] = False
            n_alive -= jpos.size
            delta = np.bitwise_or.reduce(rem_packed[jpos], axis=0) & ~pc
            keep = ~accept & live
            cand, inter, c_pop = cand[keep], inter[keep], c_pop[keep]
            live = np.ones(cand.size, bool)
            if not delta.any():
                # union unchanged -> distances unchanged: fixpoint
                break
            pc |= delta
            pc_pop = int(_popcount(pc).sum())
            bound = c_pop > one_m_tau * pc_pop
            cand, inter, c_pop = cand[bound], inter[bound], c_pop[bound]
            live = live[bound]
            if cand.size:
                # incremental: pc gained exactly delta (disjoint from the
                # old pc), so inter grows by the overlap with delta's
                # nonzero words only
                dw = np.flatnonzero(delta)
                inter = inter + _row_popcount(
                    rem_packed[cand][:, dw] & delta[dw])
            scan_end, cand, inter, c_pop, live = _extend(
                scan_end, cand, inter, c_pop, live, pc, pc_pop)
    assert out == n
    return perm


def jaccard_rows_cols_fast(csr: sp.csr_matrix,
                           block: Tuple[int, int] = (128, 128),
                           tau: float = 0.7,
                           max_candidates: Optional[int] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Row+column ablation (paper VI-F) on the fast clustering: cluster
    rows, then columns of the row-permuted matrix."""
    row_perm = jaccard_rows_fast(csr, block[1], tau, max_candidates)
    permuted = csr[row_perm]
    col_perm = jaccard_rows_fast(permuted.T.tocsr(), block[0], tau,
                                 max_candidates)
    return row_perm, col_perm


# --------------------------------------------------- block-row level schemes
def _block_indicator(csr: sp.csr_matrix, block: Tuple[int, int]
                     ) -> sp.csr_matrix:
    """Block-granularity indicator: (n_block_rows, n_block_cols) CSR with a
    stored 1 wherever the blocked matrix has a nonzero block."""
    h, w = block
    n, m = csr.shape
    nbr, nbc = -(-n // h), -(-m // w)
    coo = csr.tocoo()
    brow = coo.row // h
    bcol = coo.col // w
    data = np.ones(brow.size, np.int8)
    ind = sp.coo_matrix((data, (brow, bcol)), shape=(nbr, nbc))
    ind.sum_duplicates()
    return ind.tocsr()


def _pin_partial_last(brperm: np.ndarray, nbr: int, partial: bool
                      ) -> np.ndarray:
    """Keep a partial trailing block-row at the end so expanding a block-row
    permutation to element rows never shifts full blocks across block
    boundaries."""
    if not partial:
        return brperm
    last = nbr - 1
    return np.concatenate([brperm[brperm != last], [last]])


def _expand_block_row_perm(brperm: np.ndarray, h: int, n_rows: int
                           ) -> np.ndarray:
    """Block-row permutation -> element row permutation (the partial
    trailing block-row, if any, must already be pinned last)."""
    return np.concatenate(
        [np.arange(br * h, min((br + 1) * h, n_rows)) for br in brperm]
    ).astype(np.int64)


def shard_bins(bpr: np.ndarray, n_shards: int, *,
               rows_per_shard: Optional[int] = None,
               max_load: Optional[int] = None) -> np.ndarray:
    """Capacitated equal-cardinality LPT: block-row -> shard assignment.

    The bin-assignment primitive behind ``shard_balance`` (and the
    partitioned execution path in ``launch.dist_spmm``): block-rows are
    placed heaviest-first onto the least-loaded shard, subject to every
    shard receiving at most ``rows_per_shard`` block-rows (default
    ``ceil(n_brows / n_shards)``).  The cardinality cap is what makes the
    partition STATIC-shape friendly — each shard owns exactly
    ``rows_per_shard`` block-row slots (trailing slots virtual/empty), so
    per-shard operands keep fixed shapes across structures of the same
    dims.

    ``max_load`` optionally caps per-shard nonzero-block counts (the
    model-weight path derives it from dims so scan-stacked layers share
    leaf shapes); assignment that cannot fit raises rather than silently
    producing ragged shards.

    Returns ``assign [n_brows] int64`` with values in ``[0, n_shards)``.
    """
    bpr = np.asarray(bpr, dtype=np.int64)
    n_brows = bpr.size
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    rps = rows_per_shard or -(-max(n_brows, 1) // n_shards)
    if rps * n_shards < n_brows:
        raise ValueError(
            f"rows_per_shard={rps} x n_shards={n_shards} cannot hold "
            f"{n_brows} block-rows")
    order = np.argsort(-bpr, kind="stable")   # heaviest first
    load = np.zeros(n_shards, dtype=np.int64)
    count = np.zeros(n_shards, dtype=np.int64)
    assign = np.empty(n_brows, dtype=np.int64)
    for br in order:
        elig = count < rps
        if max_load is not None:
            fits = elig & (load + bpr[br] <= max_load)
            if fits.any():
                elig = fits
            elif not elig.any():
                raise ValueError("shard_bins: no shard has row capacity left")
            else:
                raise ValueError(
                    f"shard_bins: block-row with {int(bpr[br])} blocks "
                    f"cannot fit any shard under max_load={max_load} "
                    f"(loads={load.tolist()}); raise the per-shard nnzb "
                    "budget or lower n_shards")
        cand = np.flatnonzero(elig)
        s = cand[np.argmin(load[cand])]
        assign[br] = s
        load[s] += bpr[br]
        count[s] += 1
    return assign


def split_heavy_rows(bpr: np.ndarray, max_load: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Entry-granular fragments of a block-row load vector.

    The LPT in :func:`shard_bins` places whole block-rows, so a single
    block-row heavier than the per-shard budget can never fit — the
    extreme-skew failure mode of the partitioned execution path
    (``launch.dist_spmm``).  This splits each such row into near-equal
    CONTIGUOUS entry ranges of at most ``max_load`` blocks; the fragments
    are what the LPT then places (the row's partial products recombine
    with a sum at gather time).

    Returns ``(frag_row, frag_start, frag_len)``, one entry per fragment
    in ascending (row, start) order: the owning block-row, the offset of
    the fragment's first entry within the row, and its entry count.  Rows
    at or under ``max_load`` come back as a single fragment, so with no
    heavy row this is the identity table ``(arange, zeros, bpr)``.

    >>> import numpy as np
    >>> fr, fs, fl = split_heavy_rows(np.array([2, 7, 1]), 3)
    >>> fr.tolist(), fs.tolist(), fl.tolist()
    ([0, 1, 1, 1, 2], [0, 0, 3, 5, 0], [2, 3, 2, 2, 1])
    """
    if max_load < 1:
        raise ValueError(f"max_load must be >= 1, got {max_load}")
    bpr = np.asarray(bpr, dtype=np.int64)
    rows, starts, lens = [], [], []
    for r, load in enumerate(bpr):
        load = int(load)
        k = max(-(-load // int(max_load)), 1)
        base, rem = divmod(load, k)
        off = 0
        for i in range(k):
            size = base + (1 if i < rem else 0)
            rows.append(r)
            starts.append(off)
            lens.append(size)
            off += size
    return (np.asarray(rows, np.int64), np.asarray(starts, np.int64),
            np.asarray(lens, np.int64))


def shard_balance_rows(csr: sp.csr_matrix, block: Tuple[int, int] = (128, 128),
                       n_shards: int = 8) -> np.ndarray:
    """Element-row permutation from the block-row LPT shard balancing
    (``reorder.shard_balance``): block-rows are packed so per-shard
    nonzero-block counts even out; rows inside a block-row keep their order
    (block density untouched)."""
    h, _ = block
    ind = _block_indicator(csr, block)
    rowptr = np.asarray(ind.indptr)
    nbr = ind.shape[0]
    brperm = _shard_balance_brows(None, rowptr, n_shards)
    brperm = _pin_partial_last(brperm, nbr, csr.shape[0] % h != 0)
    return _expand_block_row_perm(brperm, h, csr.shape[0])


# --------------------------------------------------------------- BCSR entry
def _bcsr_permute_block_rows(a: bcsr_lib.BCSR, brperm: np.ndarray
                             ) -> bcsr_lib.BCSR:
    """Permute whole block-rows of a BCSR in place of a CSR round-trip:
    exact same blocks, relabeled and re-sorted — nnzb is preserved."""
    new_rows = invert_perm(brperm)[a.row_ids].astype(np.int32)
    order = np.lexsort((a.col_ids, new_rows))
    vals = a.vals[order]
    col_ids = a.col_ids[order].astype(np.int32)
    row_ids = new_rows[order]
    rowptr = bcsr_lib.rowptr_from_rows(row_ids, a.n_block_rows)
    return bcsr_lib.BCSR(vals, col_ids, row_ids, rowptr, a.shape, a.block)


def _block_row_perm(a: bcsr_lib.BCSR, scheme: str, tau: float,
                    max_candidates: Optional[int], n_shards: int
                    ) -> np.ndarray:
    """Block-row permutation for a scheme, computed on the block structure
    (patterns are block-granular already, so the bitmask clustering runs
    with block_w=1 on the indicator matrix)."""
    nbr = a.n_block_rows
    if scheme == "shard_balance":
        return _shard_balance_brows(a.row_ids, a.rowptr, n_shards)
    ind = sp.csr_matrix(
        (np.ones(a.nnzb, np.int8), a.col_ids, a.rowptr),
        shape=(nbr, a.n_block_cols))
    if scheme == "jaccard":
        return jaccard_rows_fast(ind, block_w=1, tau=tau,
                                 max_candidates=max_candidates)
    if scheme == "rcm":
        graph = (ind @ ind.T).tocsr()   # block-row connectivity (square)
        return np.asarray(sp.csgraph.reverse_cuthill_mckee(
            graph, symmetric_mode=True), dtype=np.int64)
    raise ValueError(f"scheme {scheme!r} has no block-row form")


def permute_bcsr(a: bcsr_lib.BCSR, scheme: str = "jaccard", *,
                 tau: float = 0.7, max_candidates: Optional[int] = None,
                 n_shards: int = 8, granularity: str = "element"
                 ) -> Tuple[bcsr_lib.BCSR, np.ndarray]:
    """Apply a registered reorder scheme to a host BCSR.

    Returns ``(a_permuted, row_perm)`` with ``a_permuted[i] ==
    a[row_perm[i]]`` row-wise.  ``granularity="element"`` permutes
    individual rows and re-blocks from the NONZERO structure
    (block-densifying — nnzb can change; explicitly-stored zero blocks do
    NOT survive the re-block, so their entries leave the trainable
    support); ``granularity="block_row"`` permutes whole block-rows (nnzb
    and every stored entry preserved exactly — the form model weights use
    so stacked leaf shapes stay static and zero blocks stay trainable).
    ``shard_balance`` is inherently block-granular and ignores
    ``granularity``.
    """
    if scheme not in SCHEMES:
        raise ValueError(f"unknown reorder scheme {scheme!r}; "
                         f"options: {sorted(SCHEMES)}")
    n_rows = a.shape[0]
    if scheme == "identity":
        return a, np.arange(n_rows, dtype=np.int64)
    h = a.block[0]
    if granularity == "block_row" or scheme == "shard_balance":
        brperm = _block_row_perm(a, scheme, tau, max_candidates, n_shards)
        brperm = _pin_partial_last(brperm, a.n_block_rows, n_rows % h != 0)
        return (_bcsr_permute_block_rows(a, brperm),
                _expand_block_row_perm(brperm, h, n_rows))
    if granularity != "element":
        raise ValueError(f"granularity must be 'element' or 'block_row', "
                         f"got {granularity!r}")
    csr = a.to_scipy()
    perm = SCHEMES[scheme](csr, block=a.block, tau=tau,
                           max_candidates=max_candidates, n_shards=n_shards)
    if isinstance(perm, tuple):
        raise ValueError(
            f"scheme {scheme!r} returns a column permutation too; "
            "prepare_sparse only supports row permutations (the paper "
            "rejects column permutation — it would permute B)")
    perm = np.asarray(perm, dtype=np.int64)
    return bcsr_lib.from_scipy(csr[perm].tocsr(), a.block), perm


def invert_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


# ------------------------------------------------------------------ registry
# THE dispatch table (``reorder()`` and ``prepare(reorder=...)`` both
# consume it; ``reorder.SCHEMES`` resolves to it).  Uniform signature:
#   fn(csr, *, block=(h, w), tau, max_candidates, n_shards)
#     -> row_perm  |  (row_perm, col_perm)
def _s_identity(csr, *, block=(128, 128), tau=0.7, max_candidates=None,
                n_shards=8):
    return _identity_rows(csr)


def _s_jaccard(csr, *, block=(128, 128), tau=0.7, max_candidates=None,
               n_shards=8):
    return jaccard_rows_fast(csr, block_w=block[1], tau=tau,
                             max_candidates=max_candidates)


def _s_jaccard_rows_cols(csr, *, block=(128, 128), tau=0.7,
                         max_candidates=None, n_shards=8):
    return jaccard_rows_cols_fast(csr, block=block, tau=tau,
                                  max_candidates=max_candidates)


def _s_rcm(csr, *, block=(128, 128), tau=0.7, max_candidates=None,
           n_shards=8):
    return _rcm_rows(csr)


def _s_shard_balance(csr, *, block=(128, 128), tau=0.7, max_candidates=None,
                     n_shards=8):
    return shard_balance_rows(csr, block=block, n_shards=n_shards)


SCHEMES: Dict[str, object] = {
    "identity": _s_identity,
    "jaccard": _s_jaccard,
    "jaccard_rows_cols": _s_jaccard_rows_cols,
    "rcm": _s_rcm,
    "shard_balance": _s_shard_balance,
}
