"""Block-densifying matrix reordering (paper Section IV-C).

SMaT preprocesses the sparse matrix with a row permutation ``A' = P A`` that
minimizes the number of nonzero BCSR blocks.  The paper evaluates several
schemes and settles on Sylos Labini et al.'s greedy Jaccard-similarity row
clustering; it also ablates row+column permutation and rejects the column part
(insufficient block reduction vs. the cost of permuting B).

We implement:
  * ``jaccard_rows``   — Sylos Labini greedy clustering (paper's choice).
  * ``jaccard_rows_cols`` — the paper's row+column ablation.
  * ``rcm``            — Reverse Cuthill-McKee (bandwidth minimization).
  * ``identity``       — no-op (band matrices are already block-dense).
  * ``shard_balance``  — beyond-paper: reorder *clusters* so nonzero blocks
    are balanced across mesh shards (the TPU analogue of the paper's
    warp-load-balance observation on ``mip1``).

All routines operate host-side on scipy CSR and return permutation arrays;
they run once at preprocessing time, exactly as in the paper.

The implementations here are the O(n^2) pure-Python *references*, equal
to the JAX package's ``repro.core.reorder``.  The pipeline
(``ops.prepare(reorder=...)``) dispatches through ``core.permute.SCHEMES``,
whose ``jaccard`` entry is the packed-bitmask clustering; ``reorder()``
below uses the same table.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


# --------------------------------------------------------------------- helpers
def _row_block_patterns(csr: sp.csr_matrix, block_w: int):
    """Per-row sorted arrays of *block-column* indices (the clustering works on
    block granularity: two rows are similar if their nonzero block-columns
    overlap)."""
    indptr, indices = csr.indptr, csr.indices
    out = []
    for r in range(csr.shape[0]):
        cols = indices[indptr[r]:indptr[r + 1]] // block_w
        out.append(np.unique(cols))
    return out


def _jaccard_distance(a: np.ndarray, b_set: set) -> float:
    if len(a) == 0 and len(b_set) == 0:
        return 0.0
    inter = sum(1 for x in a if x in b_set)
    union = len(a) + len(b_set) - inter
    return 1.0 - inter / union if union else 0.0


# ------------------------------------------------------- Sylos Labini greedy
def jaccard_rows(csr: sp.csr_matrix, block_w: int = 128, tau: float = 0.7,
                 max_candidates: Optional[int] = None) -> np.ndarray:
    """Greedy Jaccard row clustering (Sylos Labini et al., paper IV-C).

    Iteratively: open a cluster with the first unclustered row; merge every
    unclustered row whose Jaccard distance to the cluster's column-pattern
    union is below ``tau``.  Returns the row permutation (cluster
    concatenation order).

    ``max_candidates`` caps the scan per cluster for very large matrices
    (candidate rows are pre-bucketed by their first block-column, which keeps
    the scan near-linear in practice without changing results much).
    """
    n = csr.shape[0]
    patterns = _row_block_patterns(csr, block_w)
    unclustered = np.ones(n, dtype=bool)
    # bucket rows by first block-col so cluster scans touch plausible rows 1st
    first_col = np.array([p[0] if len(p) else -1 for p in patterns])
    order_by_first = np.argsort(first_col, kind="stable")
    perm = []
    for seed in order_by_first:
        if not unclustered[seed]:
            continue
        unclustered[seed] = False
        cluster = [seed]
        pc = set(patterns[seed].tolist())
        scanned = 0
        for cand in order_by_first:
            if not unclustered[cand]:
                continue
            scanned += 1
            if max_candidates is not None and scanned > max_candidates:
                break
            if _jaccard_distance(patterns[cand], pc) < tau:
                unclustered[cand] = False
                cluster.append(cand)
                pc.update(patterns[cand].tolist())
        perm.extend(cluster)
    return np.asarray(perm, dtype=np.int64)


def jaccard_rows_cols(csr: sp.csr_matrix, block: Tuple[int, int] = (128, 128),
                      tau: float = 0.7) -> Tuple[np.ndarray, np.ndarray]:
    """Paper ablation: cluster rows, then apply the same procedure to columns
    of the row-permuted matrix.  Returns (row_perm, col_perm)."""
    row_perm = jaccard_rows(csr, block[1], tau)
    permuted = csr[row_perm]
    col_perm = jaccard_rows(permuted.T.tocsr(), block[0], tau)
    return row_perm, col_perm


# --------------------------------------------------------------------- others
def rcm(csr: sp.csr_matrix) -> np.ndarray:
    """Reverse Cuthill-McKee bandwidth-minimizing permutation [29].

    scipy's RCM needs a square adjacency; rectangular matrices use the
    row-connectivity graph A A^T (rows adjacent when they share a column)."""
    n, m = csr.shape
    if n == m:
        sym = csr + csr.T
    else:
        sym = csr @ csr.T
    return np.asarray(
        sp.csgraph.reverse_cuthill_mckee(sym.tocsr(), symmetric_mode=True),
        dtype=np.int64)


def identity(csr: sp.csr_matrix) -> np.ndarray:
    return np.arange(csr.shape[0], dtype=np.int64)


def shard_balance(row_ids: np.ndarray, rowptr: np.ndarray,
                  n_shards: int) -> np.ndarray:
    """Beyond-paper: permute *block-rows* so per-shard nonzero-block counts are
    balanced (greedy LPT bin packing).  Returns a block-row permutation; rows
    inside a block-row keep their order so block density is untouched.

    This is the mesh-level analogue of the paper's observation that ``mip1``'s
    8.4x stddev reduction (load balance across warps) mattered more than the
    1.8x block-count reduction.
    """
    bpr = np.diff(rowptr)
    n_brows = bpr.size
    order = np.argsort(-bpr, kind="stable")  # heaviest first
    shard_load = np.zeros(n_shards, dtype=np.int64)
    shard_members: list[list[int]] = [[] for _ in range(n_shards)]
    for br in order:
        s = int(np.argmin(shard_load))
        shard_load[s] += bpr[br]
        shard_members[s].append(int(br))
    perm = [br for members in shard_members for br in sorted(members)]
    return np.asarray(perm, dtype=np.int64)


# ------------------------------------------------------------------ dispatcher
def reorder(csr: sp.csr_matrix, scheme: str = "jaccard",
            block_w: int = 128, tau: float = 0.7, **opts) -> np.ndarray:
    """Dispatch through the single ``SCHEMES`` table (defined in
    ``core.permute``, which maps ``jaccard`` to the vectorized bitmask
    clustering).  Extra ``opts`` (``max_candidates``, ``n_shards``) pass
    straight to the scheme."""
    from repro_torch.core import permute  # local: permute imports this module
    if scheme not in permute.SCHEMES:
        raise ValueError(f"unknown reorder scheme {scheme!r}; "
                         f"options: {sorted(permute.SCHEMES)}")
    return permute.SCHEMES[scheme](csr, block=(block_w, block_w), tau=tau,
                                   **opts)


def apply_perm(csr: sp.csr_matrix, row_perm: Optional[np.ndarray] = None,
               col_perm: Optional[np.ndarray] = None) -> sp.csr_matrix:
    out = csr
    if row_perm is not None:
        out = out[row_perm]
    if col_perm is not None:
        out = out[:, col_perm]
    return out.tocsr()


# The single dispatch table lives in ``core.permute``; ``reorder.SCHEMES``
# resolves to it lazily (PEP 562) because ``permute`` imports the reference
# routines defined above.
def __getattr__(name):
    if name == "SCHEMES":
        from repro_torch.core.permute import SCHEMES
        return SCHEMES
    raise AttributeError(name)
