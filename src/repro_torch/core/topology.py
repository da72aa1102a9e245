"""Synthetic sparse-matrix generators standing in for the paper's
evaluation suite.

SuiteSparse matrices are not fetched: each generator reproduces one test
matrix's pattern class, size and nnz (the paper's Table I), and ``band``
its synthetic bandwidth sweep (Section VI-C).  The CSR each returns is
exactly equal to the JAX package's ``repro.core.topology`` for the same
arguments and seed (``tests/test_torch_reorder.py``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp


def band(n: int, bandwidth: int, dtype=np.float32, seed: int = 0) -> sp.csr_matrix:
    """Band matrix: a_{ij} = 0 unless |i-j| <= bandwidth (paper VI-C)."""
    rng = np.random.default_rng(seed)
    diags = []
    offsets = []
    for k in range(-bandwidth, bandwidth + 1):
        m = n - abs(k)
        diags.append(rng.standard_normal(m).astype(dtype))
        offsets.append(k)
    return sp.diags(diags, offsets, shape=(n, n), format="csr")


def band_pattern(n: int, bandwidth: int, seed: int = 0) -> sp.csr_matrix:
    """Same sparsity pattern as ``band`` but built without materializing a
    dense diagonal list (fast for large bandwidth)."""
    if bandwidth >= n - 1:
        rng = np.random.default_rng(seed)
        return sp.csr_matrix(rng.standard_normal((n, n)).astype(np.float32))
    return band(n, bandwidth, seed=seed)


def power_law(n: int, avg_nnz_row: float, alpha: float = 2.1,
              seed: int = 0) -> sp.csr_matrix:
    """Power-law (scale-free) matrix — the `dc2` circuit-simulation adversary:
    extreme row skew, most rows nearly empty, a few very dense."""
    rng = np.random.default_rng(seed)
    # zipf-distributed row degrees scaled to the target average
    deg = rng.zipf(alpha, size=n).astype(np.float64)
    deg = np.minimum(deg * (avg_nnz_row / deg.mean()), n).astype(np.int64)
    deg = np.maximum(deg, 1)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    m = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    m.sum_duplicates()
    return m.tocsr()


def mesh2d(side: int, seed: int = 0) -> sp.csr_matrix:
    """5-point 2D stencil (FEM/CFD class: cant, rma10, consph analogues)."""
    n = side * side
    main = np.full(n, 4.0, np.float32)
    off1 = np.full(n - 1, -1.0, np.float32)
    off1[np.arange(1, n) % side == 0] = 0  # row breaks
    offs = np.full(n - side, -1.0, np.float32)
    return sp.diags([offs, off1, main, off1, offs],
                    [-side, -1, 0, 1, side], format="csr")


def mesh3d(side: int, seed: int = 0) -> sp.csr_matrix:
    """7-point 3D stencil (cop20k_A / shipsec1 structural class)."""
    n = side ** 3
    main = np.full(n, 6.0, np.float32)
    o1 = np.full(n - 1, -1.0, np.float32)
    o1[np.arange(1, n) % side == 0] = 0
    o2 = np.full(n - side, -1.0, np.float32)
    o3 = np.full(n - side * side, -1.0, np.float32)
    return sp.diags([o3, o2, o1, main, o1, o2, o3],
                    [-side * side, -side, -1, 0, 1, side, side * side],
                    format="csr")


def blocked_random(n: int, nnz_target: int, cluster: int = 48,
                   seed: int = 0) -> sp.csr_matrix:
    """Clustered random matrix (mip1 / pdb1HYS class: dense local blocks from
    optimization constraints / molecular contact maps) — rows in the same
    cluster share most of their column support, so reordering pays off."""
    rng = np.random.default_rng(seed)
    n_clusters = max(n // cluster, 1)
    rows_l, cols_l = [], []
    remaining = nnz_target
    per_cluster = max(nnz_target // n_clusters, 1)
    for c in range(n_clusters):
        r0 = c * cluster
        rsz = min(cluster, n - r0)
        if rsz <= 0:
            break
        # each cluster picks a few column neighborhoods
        n_nbh = rng.integers(1, 4)
        for _ in range(n_nbh):
            c0 = int(rng.integers(0, max(n - cluster, 1)))
            cnt = per_cluster // n_nbh
            rr = rng.integers(r0, r0 + rsz, size=cnt)
            cc = rng.integers(c0, min(c0 + cluster, n), size=cnt)
            rows_l.append(rr)
            cols_l.append(cc)
        remaining -= per_cluster
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    # scatter the rows so the *input* ordering does not expose the clusters —
    # this is what the Jaccard reordering has to rediscover
    scatter = rng.permutation(n)
    rows = scatter[rows]
    vals = rng.standard_normal(rows.size).astype(np.float32)
    m = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    m.sum_duplicates()
    return m.tocsr()


# --------------------------------------------------------------- paper Table I
# Pattern-matched stand-ins for the 9 SuiteSparse matrices.  Sizes are scaled
# down ~8x from the originals so the whole suite runs on one CPU core;
# sparsity and pattern class match Table I.
SUITE = {
    # name:            (generator, kwargs, paper_domain)
    "mip1":        (blocked_random, dict(n=8192, nnz_target=163_000, cluster=64), "optimization"),
    "conf5_4-8x8": (band,          dict(n=6144, bandwidth=24),                    "quantum chem."),
    "cant":        (mesh2d,        dict(side=88),                                 "2D/3D mesh"),
    "pdb1HYS":     (blocked_random, dict(n=4608, nnz_target=67_000, cluster=32),  "weighted graph"),
    "rma10":       (mesh2d,        dict(side=76),                                 "fluid dynamics"),
    "cop20k_A":    (mesh3d,        dict(side=24),                                 "2D/3D mesh"),
    "consph":      (mesh3d,        dict(side=22),                                 "2D/3D mesh"),
    "shipsec1":    (mesh3d,        dict(side=26),                                 "structural"),
    "dc2":         (power_law,     dict(n=14336, avg_nnz_row=7.0),                "circuit sim."),
}


def suite_matrix(name: str, seed: int = 0) -> sp.csr_matrix:
    gen, kwargs, _ = SUITE[name]
    return gen(seed=seed, **kwargs)


def suite_all(seed: int = 0) -> Dict[str, sp.csr_matrix]:
    return {name: suite_matrix(name, seed) for name in SUITE}
