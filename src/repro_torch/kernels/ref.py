"""Plain PyTorch versions of the BCSR SpMM kernel.

``bcsr_spmm_ref`` is the CUDA kernel's plain twin: the CPU path of its
wrapper, the ``xla`` backend of ``ops.spmm`` (the name is kept from the JAX
package, where it was the plain jnp path), and the oracle the kernel is
held against on the card.  Products accumulate in float32.
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


def spmm_dense_ref(a_dense: torch.Tensor, b: torch.Tensor,
                   out_dtype=None) -> torch.Tensor:
    """Multiply the (explicitly padded) dense matrix in float32."""
    out = a_dense.float() @ b.float()
    return out.to(out_dtype or b.dtype)
