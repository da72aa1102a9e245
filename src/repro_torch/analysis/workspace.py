"""Shared workspace byte estimators -- ONE implementation.

Two families of formulas live here.

* The JAX package's (``repro.analysis.workspace``), unchanged: its
  ``autotune.pick_bn`` uses ``fits_vmem`` to keep an N tile's working set
  (A block + B tile + f32 accumulator) inside a budget, and the parity
  tests hold these formulas.  They model the TPU kernels' VMEM cells, not
  the CUDA kernels, so the port's ``autotune.pick_bn`` budgets the CUDA
  kernels' shared memory below instead (``autotune.tile_fits``).  The name
  ``fits_vmem`` is kept for parity with the JAX package.
* The CUDA kernels' own: the dynamic shared memory and threads of each
  compiled instantiation, each a mirror of the C++ constant its launch
  uses (``spmm_smem_bytes``: ``spmm_tile.cuh`` ``Layout::kSmemBytes``;
  ``sddmm_smem_bytes``: ``sddmm_tile.cuh`` ``Layout::kSmemBytes``;
  ``attn_smem_bytes``: ``bcsr_attn.cu`` ``smem_bytes``), their static
  shared memory, and the H100's limits that the launch verifier
  (``analysis.verify_launch``) holds them to.  Each library answers the
  same questions from its own constants (``*_smem_bytes``, ``*_threads``
  C queries); ``chip_smoke.py`` holds the two equal on the card.

All sizes are bytes per kernel instance (per head for attention).

>>> spmm_cell_bytes((16, 16), 512)
49664
>>> attn_fused_state_bytes((16, 16), 64)
24576
>>> H100_SMEM_PER_CTA
232448
>>> import torch
>>> spmm_smem_bytes(torch.bfloat16, 128, 64, True)
110592
>>> sddmm_smem_bytes(torch.float32, True, False)
55296
>>> attn_smem_bytes(128, 128, 0)
121856
"""
from __future__ import annotations

# ---------------------------------------------------------- the H100's limits
# NVIDIA's Hopper tuning guide and data sheet (the ``hopper-kernels`` guide):
# the shared memory one CTA may opt in to (227 KB, with
# ``cudaFuncAttributeMaxDynamicSharedMemorySize``), static included
H100_SMEM_PER_CTA = 227 * 1024
H100_SMEM_PER_SM = 228 * 1024        # of which each resident CTA reserves:
H100_SMEM_RESERVED_PER_CTA = 1024
H100_REGS_PER_SM = 65536             # 32-bit registers
H100_MAX_REGS_PER_THREAD = 255
H100_REG_ALLOC_WARP = 256            # registers are granted a warp at a time
H100_THREADS_PER_SM = 2048
H100_CTAS_PER_SM = 32
H100_GRID_X = 2 ** 31 - 1
H100_GRID_YZ = 65535                 # gridDim.y and gridDim.z

_ESIZE = {"float32": 4, "bfloat16": 2}


def _esize(dtype) -> int:
    name = str(dtype).rsplit(".", 1)[-1]
    if name not in _ESIZE:
        raise ValueError(f"the kernels take float32 or bfloat16, not {dtype}")
    return _ESIZE[name]


def spmm_cell_bytes(block: tuple[int, int], bn: int) -> int:
    """Working-set bytes of one (block, bn) SpMM/SDDMM grid cell: the
    bf16 A-block + bf16 B-panel + f32 accumulator the JAX package's
    ``pick_bn`` budgets.

    >>> spmm_cell_bytes((32, 32), 256) == (32*32 + 32*256)*2 + 32*256*4
    True
    """
    h, w = block
    return (h * w + w * bn) * 2 + (h * bn) * 4


def fits_vmem(block: tuple[int, int], bn: int,
              budget: int = H100_SMEM_PER_CTA) -> bool:
    """True iff a (block, bn) cell double-buffers inside ``budget`` --
    the JAX package's ``autotune.pick_bn`` predicate, kept as its twin.

    >>> fits_vmem((128, 128), 64)
    True
    >>> fits_vmem((128, 128), 65536)
    False
    """
    return spmm_cell_bytes(block, bn) * 2 <= budget


def attn_composed_workspace_bytes(meta) -> int:
    """Peak intermediate bytes of the composed SDDMM -> softmax -> SpMM
    attention path per head instance: it materializes the f32 scores AND
    probs tensors between its three launches (``2 * nnzb * h * w * 4``).
    """
    h, w = meta.block
    return 2 * meta.nnzb * h * w * 4


def attn_fused_state_bytes(block: tuple[int, int], head_dim: int) -> int:
    """Per-block-row running state of the fused one-kernel attention path:
    the (h, 128) max and denominator lanes plus the (h, dpad) context
    accumulator, all f32.  O(L * d) total -- independent of nnzb.
    """
    h, _ = block
    dpad = max(-(-head_dim // 128), 1) * 128
    return h * (2 * 128 + dpad) * 4


# ------------------------------------------------ the CUDA kernels' own
# spmm_tile.cuh (B1, B3): ``kStages`` ring slots; the entry ids staged in
# two ``__shared__ int [kWin]`` arrays (static shared memory)
SPMM_STAGES = 4
SPMM_WIN = 128
SPMM_STATIC_SMEM = 2 * SPMM_WIN * 4
SPMM_ROW_BLOCKS = (16, 128)
# sddmm_tile.cuh (B2, B4): one 64 x 64 tile a CTA, 4 warps,
# ``__launch_bounds__(128, 4)``
SDDMM_STAGES = 3
SDDMM_TILE = 64
SDDMM_THREADS = 128
SDDMM_MIN_CTAS = 4
SDDMM_STATIC_SMEM = 0
# bcsr_attn.cu (B5): up to 8 warps, ``__launch_bounds__(256, 1)``; K and V
# chunks of 32 keys x 128 columns; ``__shared__ int n_live``, which ptxas
# places in 16 bytes (the dynamic array after it is 16-byte aligned)
ATTN_MAX_WARPS = 8
ATTN_STAGES = 3
ATTN_KEY_TILE = 32
ATTN_CHUNK = 128
ATTN_STATIC_SMEM = 16
ATTN_MAX_D = 256
ATTN_MAX_W = 128


def spmm_threads(bm: int) -> int:
    """Threads of a B1/B3 CTA: ``spmm_tile::threads_for`` (8 warps at
    BM = 128, else 4)."""
    return 256 if bm == 128 else 128


def spmm_smem_bytes(dtype, bm: int, bn: int, kmajor: bool) -> int:
    """Dynamic shared memory of one B1/B3 instantiation, bytes: the
    ``spmm_tile.cuh`` ``Layout<T, BM, BN, KMAJ>::kSmemBytes`` -- the ring
    of ``SPMM_STAGES`` chunk slots (A's [BM, KC] and B's [KC, BN] or
    [BN, KC] chunk, rows padded), or the f32 epilogue tile that reuses it,
    whichever is larger.  It depends on the type, BM, BN and B's staging
    only, never on the block or N.

    >>> import torch
    >>> spmm_smem_bytes(torch.bfloat16, 16, 8, False)
    26112
    """
    es = _esize(dtype)
    if bm not in SPMM_ROW_BLOCKS:
        raise ValueError(f"BM is one of {SPMM_ROW_BLOCKS}, not {bm}")
    kc = (256 if bm == 16 else 128) // es           # chunk columns
    a_stride = kc + 16 // es
    if kmajor:
        b_stride, b_rows = bn + (0 if bn == 8 else 8), kc
    else:
        b_stride, b_rows = kc + 16 // es, bn
    stage = bm * a_stride + b_rows * b_stride
    ring = SPMM_STAGES * stage * es
    wk = spmm_threads(bm) // 32 // (bm // 16)       # warps along a chunk
    epilogue = wk * bm * (bn + 4) * 4
    return max(ring, epilogue)


def sddmm_smem_bytes(dtype, ak: bool, bk: bool) -> int:
    """Dynamic shared memory of one B2/B4 instantiation, bytes: the
    ``sddmm_tile.cuh`` ``Layout<T, AK, BK>::kSmemBytes`` -- a ring of
    ``SDDMM_STAGES`` slots of both operands' 64-row chunks of 128 bytes a
    row (staged [KC][64] k-major, else [64][KC]), or the f32 epilogue
    tile, whichever is larger.

    >>> import torch
    >>> sddmm_smem_bytes(torch.bfloat16, True, True)
    55296
    """
    es = _esize(dtype)
    kc = 128 // es

    def operand(kmaj):
        stride = SDDMM_TILE + 8 if kmaj else kc + 16 // es
        return (kc if kmaj else SDDMM_TILE) * stride
    ring = SDDMM_STAGES * (operand(ak) + operand(bk)) * es
    epilogue = SDDMM_TILE * (SDDMM_TILE + 8) * 4
    return max(ring, epilogue)


def attn_warps(h: int) -> int:
    """Warps of a B5 CTA: ``bcsr_attn.cu`` ``warps_for`` (one per 16 query
    rows, at most 8)."""
    return ATTN_MAX_WARPS if h >= 16 * ATTN_MAX_WARPS else -(-h // 16)


def attn_threads(h: int) -> int:
    """Threads of a B5 CTA: ``32 * warps_for(h)``."""
    return 32 * attn_warps(h)


def attn_smem_bytes(d: int, h: int, max_bpr: int) -> int:
    """Dynamic shared memory of a B5 launch, bytes: ``bcsr_attn.cu``
    ``smem_bytes`` -- the Q slice [16W, ceil(d/32)*32 + 8] f32, a ring of
    ``ATTN_STAGES`` K/V chunk slots, and 8 bytes a schedule slot for the
    row's live entry and column ids.  It grows with ``max_bpr``: past
    ``attn_max_bpr`` the launch is refused."""
    slot = ATTN_KEY_TILE * max(ATTN_CHUNK + 8, ATTN_CHUNK + 4)
    q_rows = 16 * attn_warps(h)
    return (4 * (q_rows * (-(-d // 32) * 32 + 8) + ATTN_STAGES * slot)
            + 8 * max_bpr)


def attn_max_bpr(d: int, h: int, budget: int = H100_SMEM_PER_CTA) -> int:
    """The largest ``max_bpr`` whose B5 launch fits ``budget`` with the
    kernel's static shared memory.

    >>> attn_max_bpr(128, 128)
    13822
    """
    return (budget - ATTN_STATIC_SMEM - attn_smem_bytes(d, h, 0)) // 8


def ctas_per_sm(threads: int, regs: int, smem: int) -> int:
    """CTAs of ``threads`` threads, ``regs`` registers a thread and
    ``smem`` bytes of shared memory (static + dynamic) that one SM holds at
    once: the least of the thread, CTA, register and shared-memory limits
    (each CTA reserves ``H100_SMEM_RESERVED_PER_CTA`` more; registers are
    granted ``H100_REG_ALLOC_WARP`` to a warp at a time).

    >>> ctas_per_sm(128, 119, 55296)
    4
    """
    warps = -(-threads // 32)
    per_warp = -(-max(regs, 1) * 32 // H100_REG_ALLOC_WARP) * \
        H100_REG_ALLOC_WARP
    by_regs = H100_REGS_PER_SM // (per_warp * warps)
    by_smem = H100_SMEM_PER_SM // (smem + H100_SMEM_RESERVED_PER_CTA)
    return min(H100_CTAS_PER_SM, H100_THREADS_PER_SM // threads, by_regs,
               by_smem)
