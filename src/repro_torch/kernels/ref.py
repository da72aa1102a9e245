"""Plain PyTorch versions of the BCSR SpMM and SDDMM kernels.

``bcsr_spmm_ref`` and ``bcsr_sddmm_ref`` are the CUDA kernels' plain twins:
the CPU path of their wrappers, the ``xla`` backend of ``ops.spmm`` /
``ops.sddmm`` (the name is kept from the JAX package, where it was the plain
jnp path), and the oracles the kernels are held against on the card.
``spmm_dense_ref`` and ``bcsr_sddmm_dense_ref`` are the ``dense`` backends.
Products accumulate in float32.
"""
from __future__ import annotations

import torch


def bcsr_spmm_ref(vals: torch.Tensor, row_ids: torch.Tensor,
                  col_ids: torch.Tensor, b: torch.Tensor,
                  n_block_rows: int, out_dtype=None) -> torch.Tensor:
    """C = A @ B with A in BCSR block form.

    vals     [nnzb, h, w]
    row_ids  [nnzb] block-row of each block
    col_ids  [nnzb] block-col of each block
    b        [K, N] dense (K must be a multiple of w)
    returns  [n_block_rows * h, N]
    """
    nnzb, h, w = vals.shape
    K, N = b.shape
    if K % w:
        raise ValueError(f"K={K} must be a multiple of the block width {w}")
    gathered = b.reshape(K // w, w, N)[col_ids.long()]      # [nnzb, w, N]
    prod = torch.einsum("shw,swn->shn", vals.float(), gathered.float())
    out = torch.zeros((n_block_rows, h, N), dtype=torch.float32,
                      device=b.device)
    out.index_add_(0, row_ids.long(), prod)
    return out.reshape(n_block_rows * h, N).to(out_dtype or b.dtype)


def bcsr_sddmm_ref(dc: torch.Tensor, b: torch.Tensor, row_ids: torch.Tensor,
                   col_ids: torch.Tensor, h: int, w: int,
                   out_dtype=None) -> torch.Tensor:
    """dVals = (dC @ B^T) sampled at the nonzero blocks (the weight gradient
    of the sparse operand).

    dc       [M, N]   upstream cotangent (M multiple of h)
    b        [K, N]   the dense forward operand (K multiple of w)
    returns  [nnzb, h, w]
    """
    M, N = dc.shape
    K, _ = b.shape
    dc_blocks = dc.reshape(M // h, h, N)[row_ids.long()]     # [nnzb, h, N]
    b_blocks = b.reshape(K // w, w, N)[col_ids.long()]       # [nnzb, w, N]
    dvals = torch.einsum("shn,swn->shw", dc_blocks.float(), b_blocks.float())
    return dvals.to(out_dtype or dc.dtype)


def bcsr_sddmm_dense_ref(dc: torch.Tensor, b: torch.Tensor,
                         row_ids: torch.Tensor, col_ids: torch.Tensor,
                         h: int, w: int, out_dtype=None) -> torch.Tensor:
    """The dense arm of SDDMM: the FULL ``dC @ B^T`` in float32, then the
    stored blocks gathered out of it."""
    M, N = dc.shape
    K, _ = b.shape
    full = dc.float() @ b.float().T                          # [M, K]
    blocks = full.reshape(M // h, h, K // w, w).permute(0, 2, 1, 3)
    return blocks[row_ids.long(), col_ids.long()].to(out_dtype or dc.dtype)


def spmm_dense_ref(a_dense: torch.Tensor, b: torch.Tensor,
                   out_dtype=None) -> torch.Tensor:
    """Multiply the (explicitly padded) dense matrix in float32."""
    out = a_dense.float() @ b.float()
    return out.to(out_dtype or b.dtype)
