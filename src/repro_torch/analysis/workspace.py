"""Shared workspace byte estimators -- ONE implementation.

The formulas are the JAX package's (``repro.analysis.workspace``),
unchanged: ``autotune.pick_bn`` uses ``fits_vmem`` to keep an N tile's
working set (A block + B tile + f32 accumulator) inside a budget.  On the
H100 that budget is the shared memory one CTA may opt in to,
``H100_SMEM_PER_CTA``; the name ``fits_vmem`` is kept for parity with the
JAX package.

All sizes are bytes per kernel instance (per head for attention).

>>> spmm_cell_bytes((16, 16), 512)
49664
>>> attn_fused_state_bytes((16, 16), 64)
24576
>>> H100_SMEM_PER_CTA
232448
"""
from __future__ import annotations

# The most shared memory one CTA can use on an H100 (227 KB, with
# ``cudaFuncAttributeMaxDynamicSharedMemorySize``): NVIDIA's Hopper tuning
# guide.
H100_SMEM_PER_CTA = 227 * 1024


def spmm_cell_bytes(block: tuple[int, int], bn: int) -> int:
    """Working-set bytes of one (block, bn) SpMM/SDDMM grid cell: the
    bf16 A-block + bf16 B-panel + f32 accumulator ``pick_bn`` budgets.

    >>> spmm_cell_bytes((32, 32), 256) == (32*32 + 32*256)*2 + 32*256*4
    True
    """
    h, w = block
    return (h * w + w * bn) * 2 + (h * bn) * 4


def fits_vmem(block: tuple[int, int], bn: int,
              budget: int = H100_SMEM_PER_CTA) -> bool:
    """True iff a (block, bn) cell double-buffers inside ``budget`` --
    the exact feasibility predicate ``autotune.pick_bn`` uses.

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
