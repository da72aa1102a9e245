"""The paper's empirical performance model (Section III) + H100 roofline terms.

Eq. 1:  T_tot = T_e * n_e + T_init

  n_e  — number of nonzero BCSR blocks (elementary MMA computations)
  T_e  — time of one elementary computation (one block product here)
  T_init — startup / warm-up / finalization overhead

The paper fits (T_e, T_init) on band matrices of varying bandwidth and shows
the fit matches measurement.  The functions are the JAX package's
(``repro.core.perf_model``); their default constants are the NVIDIA H100
SXM's, so the autotuner's analytic picks model the card the kernels run on.
Pass other constants explicitly to model another part.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

# ------------------------------------------------------- H100 SXM constants
# NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense (no sparsity)
PEAK_FLOPS_BF16 = 989e12     # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink bytes/s per direction (900 GB/s total)
PCIE_BW = 64e9               # PCIe Gen5 x16 host link, bytes/s per direction

# A100-SXM4-40GB constants (the paper's platform, for cross-checks)
A100_PEAK_FP16_TC = 312e12
A100_HBM_BW = 1.555e12


@dataclasses.dataclass
class LinearFit:
    t_e: float
    t_init: float
    r2: float

    def predict(self, n_e: np.ndarray) -> np.ndarray:
        return self.t_e * np.asarray(n_e, dtype=np.float64) + self.t_init


def fit(n_e: Sequence[float], t_tot: Sequence[float]) -> LinearFit:
    """Least-squares fit of Eq. 1 on measured (n_e, T_tot) pairs."""
    x = np.asarray(n_e, dtype=np.float64)
    y = np.asarray(t_tot, dtype=np.float64)
    A = np.stack([x, np.ones_like(x)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = A @ coef
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum()) or 1.0
    return LinearFit(t_e=float(coef[0]), t_init=float(coef[1]),
                     r2=1.0 - ss_res / ss_tot)


# ------------------------------------------------------------- block model
def block_mma_time(h: int, w: int, n: int,
                   bytes_per_el: int = 2,
                   peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW) -> Tuple[float, float, float]:
    """Roofline time of ONE elementary block computation: an
    (h x w) @ (w x n) block product with its device-memory traffic.

    Returns (t_compute, t_memory, t_e = max of both), the block analogue of
    the paper's single-MMA-instruction T_e: the A block is streamed every
    time (sparse blocks are never reused) and the B tile is charged in
    full (no reuse assumed).
    """
    flops = 2.0 * h * w * n
    t_comp = flops / peak_flops
    bytes_moved = (h * w) * bytes_per_el          # A block (always streamed)
    bytes_moved += (w * n) * bytes_per_el         # B tile (worst case, no reuse)
    t_mem = bytes_moved / hbm_bw
    return t_comp, t_mem, max(t_comp, t_mem)


def spmm_model_time(n_e: int, h: int, w: int, n: int,
                    t_init: float = 5e-6, **kw) -> float:
    """Eq. 1 instantiated with the block roofline T_e."""
    _, _, t_e = block_mma_time(h, w, n, **kw)
    return t_e * n_e + t_init


def spmm_effective_gflops(nnz: int, n: int, t_tot: float) -> float:
    """Paper's effective-FLOP/s metric: useful flops = 2*nnz*N (zeros in
    padding don't count)."""
    return 2.0 * nnz * n / t_tot / 1e9


def dense_gemm_time(m: int, k: int, n: int,
                    bytes_per_el: int = 2,
                    peak_flops: float = PEAK_FLOPS_BF16,
                    hbm_bw: float = HBM_BW) -> float:
    """cuBLAS-arm model: dense GEMM roofline (for the crossover study)."""
    t_comp = 2.0 * m * k * n / peak_flops
    t_mem = (m * k + k * n + m * n) * bytes_per_el / hbm_bw
    return max(t_comp, t_mem)


def csr_spmm_time(nnz: int, n: int,
                  bytes_per_el: int = 4,
                  hbm_bw: float = HBM_BW,
                  gather_overhead: float = 8.0) -> float:
    """cuSPARSE-arm model: scalar CSR SpMM is gather-bound; each nonzero
    triggers ~(index + value + N-row access) irregular traffic.  The
    ``gather_overhead`` multiplier captures non-coalesced access (fitted to
    the paper's cuSPARSE curves, which sit ~1-2 orders below peak)."""
    bytes_moved = nnz * (4 + bytes_per_el + n * bytes_per_el) * gather_overhead
    return bytes_moved / hbm_bw
