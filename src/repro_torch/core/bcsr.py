"""BCSR (Blocked Compressed Sparse Row) format — the paper's core data structure.

A sparse matrix ``A`` of logical shape ``(M, K)`` is tiled into dense blocks of
shape ``(h, w)``; only blocks containing at least one nonzero are stored.  The
default production block is 128x128.

Arrays (mirroring the paper's Figure 1, plus ``row_ids``):

  vals     [nnzb, h, w]   dense block values (zero-padded)
  col_ids  [nnzb]         block-column index of each block
  row_ids  [nnzb]         block-row index of each block (sorted, row-major)
  rowptr   [n_brows + 1]  CSR-style offsets into col_ids/vals per block-row

The representation is host-side NumPy and stays so: ``kernels.ops.prepare``
turns it into the device tensors the CUDA kernel reads.  Every function here
returns arrays equal, element for element, to the JAX package's
``repro.core.bcsr`` on the same inputs (``tests/test_torch_bcsr.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import scipy.sparse as sp


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def rowptr_from_rows(row_ids: np.ndarray, n_block_rows: int) -> np.ndarray:
    """CSR-style offsets [n_block_rows + 1] from (sorted) block-row ids —
    the single rebuild used by every constructor."""
    rowptr = np.zeros(n_block_rows + 1, dtype=np.int32)
    np.add.at(rowptr, np.asarray(row_ids) + 1, 1)
    return np.cumsum(rowptr).astype(np.int32)


@dataclasses.dataclass
class BCSR:
    """Host-side blocked-CSR matrix (numpy)."""

    vals: np.ndarray      # [nnzb, h, w]
    col_ids: np.ndarray   # [nnzb] int32
    row_ids: np.ndarray   # [nnzb] int32
    rowptr: np.ndarray    # [n_brows + 1] int32
    shape: Tuple[int, int]
    block: Tuple[int, int]

    @property
    def nnzb(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_block_rows(self) -> int:
        return _ceil_div(self.shape[0], self.block[0])

    @property
    def n_block_cols(self) -> int:
        return _ceil_div(self.shape[1], self.block[1])

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.vals))

    @property
    def padding_ratio(self) -> float:
        """Fraction of stored values that are explicit zeros (paper's padding)."""
        total = self.vals.size
        return 1.0 - self.nnz / max(total, 1)

    @property
    def density(self) -> float:
        return self.nnz / (self.shape[0] * self.shape[1])

    def blocks_per_row(self) -> np.ndarray:
        return np.diff(self.rowptr)

    def dispatch_stats(self) -> Tuple[int, int, int]:
        """(max_bpr, padding_ratio_pct, bpr_cv_pct) — the structure stats a
        ``SparseMeta`` carries."""
        bpr = self.blocks_per_row().astype(np.float64)
        mean = float(bpr.mean()) if bpr.size else 0.0
        cv = float(bpr.std() / mean) if mean > 0 else 0.0
        return (int(bpr.max()) if bpr.size else 0,
                int(round(self.padding_ratio * 100)),
                int(round(cv * 100)))

    def block_bounds(self) -> Tuple[int, int]:
        """The paper's Eq. 2 bounds on the number of blocks n_e for this
        matrix's nnz."""
        h, w = self.block
        n, m = self.shape
        nnz = self.nnz
        lo = _ceil_div(nnz, h * w)
        hi = min(_ceil_div(n, h) * _ceil_div(m, w), nnz)
        return lo, hi

    def stats(self) -> dict:
        bpr = self.blocks_per_row()
        lo, hi = self.block_bounds()
        return {
            "shape": self.shape,
            "block": self.block,
            "nnz": self.nnz,
            "nnzb": self.nnzb,
            "padding_ratio": self.padding_ratio,
            "blocks_per_row_mean": float(bpr.mean()) if bpr.size else 0.0,
            "blocks_per_row_std": float(bpr.std()) if bpr.size else 0.0,
            "blocks_per_row_max": int(bpr.max()) if bpr.size else 0,
            "n_e_lower_bound": lo,
            "n_e_upper_bound": hi,
        }

    def to_dense(self) -> np.ndarray:
        h, w = self.block
        M, K = self.shape
        out = np.zeros((self.n_block_rows * h, self.n_block_cols * w),
                       dtype=self.vals.dtype)
        for s in range(self.nnzb):
            i, j = int(self.row_ids[s]), int(self.col_ids[s])
            out[i * h:(i + 1) * h, j * w:(j + 1) * w] = self.vals[s]
        return out[:M, :K]

    def to_scipy(self) -> sp.csr_matrix:
        """The nonzero structure as a scipy CSR matrix (reordering works on
        element rows).  Stored zeros are dropped: this is the structure
        view, not a value-preserving round trip."""
        h, w = self.block
        s, i, j = np.nonzero(self.vals)
        rows = self.row_ids[s].astype(np.int64) * h + i
        cols = self.col_ids[s].astype(np.int64) * w + j
        m = sp.coo_matrix((self.vals[s, i, j], (rows, cols)),
                          shape=self.shape)
        return m.tocsr()

    def transpose(self) -> "BCSR":
        """Block-structure transpose (the operand of dB = A^T @ dC)."""
        order = np.lexsort((self.row_ids, self.col_ids))  # sort by (col, row)
        t_vals = np.ascontiguousarray(
            np.transpose(self.vals[order], (0, 2, 1)))
        t_rows = self.col_ids[order].astype(np.int32)
        t_cols = self.row_ids[order].astype(np.int32)
        rowptr = rowptr_from_rows(t_rows, self.n_block_cols)
        return BCSR(t_vals, t_cols, t_rows, rowptr,
                    (self.shape[1], self.shape[0]),
                    (self.block[1], self.block[0]))

    def ensure_nonempty_rows(self, return_mask: bool = False):
        """Pad so every block-row holds >= 1 block.

        With ``return_mask=True`` returns ``(padded, real_mask)`` where
        ``real_mask[s]`` is False exactly for the entries this call
        appended.  The padding is tagged BEFORE the lexsort, so genuinely
        zero original blocks stay marked real."""
        bpr = self.blocks_per_row()
        empty = np.flatnonzero(bpr == 0)
        if empty.size == 0:
            if return_mask:
                return self, np.ones(self.nnzb, dtype=bool)
            return self
        h, w = self.block
        pad_vals = np.zeros((empty.size, h, w), dtype=self.vals.dtype)
        vals = np.concatenate([self.vals, pad_vals], axis=0)
        col_ids = np.concatenate([self.col_ids,
                                  np.zeros(empty.size, np.int32)])
        row_ids = np.concatenate([self.row_ids, empty.astype(np.int32)])
        real = np.concatenate([np.ones(self.nnzb, dtype=bool),
                               np.zeros(empty.size, dtype=bool)])
        order = np.lexsort((col_ids, row_ids))
        vals, col_ids, row_ids = vals[order], col_ids[order], row_ids[order]
        real = real[order]
        rowptr = rowptr_from_rows(row_ids, self.n_block_rows)
        padded = BCSR(vals, col_ids.astype(np.int32),
                      row_ids.astype(np.int32), rowptr, self.shape,
                      self.block)
        if return_mask:
            return padded, real
        return padded

    def astype(self, dtype) -> "BCSR":
        return dataclasses.replace(self, vals=self.vals.astype(dtype))


# ---------------------------------------------------------------- constructors
def from_dense(a: np.ndarray, block: Tuple[int, int]) -> BCSR:
    """Block a dense matrix, keeping only nonzero blocks."""
    h, w = block
    M, K = a.shape
    nbr, nbc = _ceil_div(M, h), _ceil_div(K, w)
    padded = np.zeros((nbr * h, nbc * w), dtype=a.dtype)
    padded[:M, :K] = a
    blocks = padded.reshape(nbr, h, nbc, w).transpose(0, 2, 1, 3)
    mask = np.abs(blocks).sum(axis=(2, 3)) != 0  # [nbr, nbc]
    row_ids, col_ids = np.nonzero(mask)
    vals = np.ascontiguousarray(blocks[row_ids, col_ids])
    rowptr = rowptr_from_rows(row_ids, nbr)
    return BCSR(vals, col_ids.astype(np.int32), row_ids.astype(np.int32),
                rowptr, (M, K), (h, w))


def from_csr(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
             shape: Tuple[int, int], block: Tuple[int, int]) -> BCSR:
    """CSR -> BCSR, the paper's input path (its Figure 1, left).  Duplicate
    coordinates are summed, as scipy's ``sum_duplicates`` does."""
    h, w = block
    M, K = shape
    nbr, nbc = _ceil_div(M, h), _ceil_div(K, w)
    coo = sp.csr_matrix((data, indices, indptr), shape=shape).tocoo()
    bid = (coo.row // h).astype(np.int64) * nbc + (coo.col // w).astype(
        np.int64)
    uniq, inv = np.unique(bid, return_inverse=True)
    vals = np.zeros((uniq.size, h, w), dtype=data.dtype)
    np.add.at(vals, (inv, coo.row % h, coo.col % w), coo.data)
    row_ids = (uniq // nbc).astype(np.int32)
    col_ids = (uniq % nbc).astype(np.int32)
    rowptr = rowptr_from_rows(row_ids, nbr)
    return BCSR(vals, col_ids, row_ids, rowptr, shape, block)


def from_scipy(mat, block: Tuple[int, int]) -> BCSR:
    csr = mat.tocsr()
    return from_csr(csr.indptr, csr.indices, csr.data, csr.shape, block)


def random_bcsr_exact(key: int, shape: Tuple[int, int],
                      block: Tuple[int, int], nnzb: int,
                      dtype=np.float32) -> BCSR:
    """Random block-sparse matrix with EXACTLY ``nnzb`` blocks, every
    block-row and block-col covered (no padding entries needed).  Every
    layer of a model shares nnzb this way."""
    rng = np.random.default_rng(key)
    h, w = block
    nbr, nbc = _ceil_div(shape[0], h), _ceil_div(shape[1], w)
    if not max(nbr, nbc) <= nnzb <= nbr * nbc:
        raise ValueError(f"nnzb={nnzb} must lie in [{max(nbr, nbc)}, "
                         f"{nbr * nbc}] (one block per row and col)")
    # cover every row and col first (diagonal-ish assignment)
    base_rows = np.arange(max(nbr, nbc)) % nbr
    base_cols = np.arange(max(nbr, nbc)) % nbc
    chosen = set(zip(base_rows.tolist(), base_cols.tolist()))
    while len(chosen) < nnzb:
        need = nnzb - len(chosen)
        rr = rng.integers(0, nbr, size=need * 2)
        cc = rng.integers(0, nbc, size=need * 2)
        for r, c in zip(rr.tolist(), cc.tolist()):
            if len(chosen) >= nnzb:
                break
            chosen.add((r, c))
    pairs = np.array(sorted(chosen), dtype=np.int64)[:nnzb]
    row_ids = pairs[:, 0].astype(np.int32)
    col_ids = pairs[:, 1].astype(np.int32)
    vals = (rng.standard_normal((nnzb, h, w)) / math.sqrt(w)).astype(dtype)
    rowptr = rowptr_from_rows(row_ids, nbr)
    return BCSR(vals, col_ids, row_ids, rowptr, shape, block)


def random_bcsr(key: int, shape: Tuple[int, int], block: Tuple[int, int],
                block_density: float, dtype=np.float32,
                fill_density: float = 1.0) -> BCSR:
    """Random block-sparse matrix: a ``block_density`` fraction of blocks are
    nonzero; within each block a ``fill_density`` fraction of entries are
    nonzero (fill < 1 models the paper's padding)."""
    rng = np.random.default_rng(key)
    h, w = block
    nbr, nbc = _ceil_div(shape[0], h), _ceil_div(shape[1], w)
    mask = rng.random((nbr, nbc)) < block_density
    row_ids, col_ids = np.nonzero(mask)
    nnzb = row_ids.size
    vals = (rng.standard_normal((nnzb, h, w)) / math.sqrt(w)).astype(dtype)
    if fill_density < 1.0:
        keep = rng.random((nnzb, h, w)) < fill_density
        vals = np.where(keep, vals, 0).astype(dtype)
    rowptr = rowptr_from_rows(row_ids, nbr)
    return BCSR(vals, col_ids.astype(np.int32), row_ids.astype(np.int32),
                rowptr, shape, block)
