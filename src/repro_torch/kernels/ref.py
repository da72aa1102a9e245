"""Plain PyTorch versions of the BCSR SpMM, SDDMM and fused attention
kernels.

``bcsr_spmm_ref`` and ``bcsr_sddmm_ref`` are the streamed kernels' plain
twins: the CPU path of their wrappers, the ``xla`` backend of ``ops.spmm`` /
``ops.sddmm`` (the name is kept from the JAX package, where it was the plain
jnp path), and the oracles the kernels are held against on the card.
``bcsr_spmm_row_loop_ref`` and ``bcsr_sddmm_row_loop_ref`` are the
``row_loop`` kernels' twins: they read the same static schedule arrays as
the kernels, padding slots and sentinel included, so the CPU tests pin that
logic.  ``spmm_dense_ref`` and ``bcsr_sddmm_dense_ref`` are the ``dense``
backends.  ``bcsr_attn_fused_ref`` is the fused block-sparse attention
kernel's twin: its two passes over the mask schedule (the row max, then
the denominator and the context together, divided once at the end).
Products accumulate in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from repro_torch.core.attention_mask import NEG_INF


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


def bcsr_spmm_row_loop_ref(vals: torch.Tensor, flat_idx: torch.Tensor,
                           flat_col: torch.Tensor, row_len: torch.Tensor,
                           b: torch.Tensor, n_block_rows: int,
                           out_dtype=None) -> torch.Tensor:
    """C = A @ B through the static schedule: slot t of block-row i
    multiplies entry ``flat_idx[i * max_bpr + t]`` by the B panel of block-col
    ``flat_col[i * max_bpr + t]``; slots with ``t >= row_len[i]`` (padding,
    pointing at entry 0) are masked out.

    flat_idx, flat_col [n_block_rows * max_bpr]; row_len [n_block_rows]
    returns [n_block_rows * h, N]
    """
    nnzb, h, w = vals.shape
    K, N = b.shape
    if K % w:
        raise ValueError(f"K={K} must be a multiple of the block width {w}")
    max_bpr = flat_idx.shape[0] // n_block_rows
    slot = torch.arange(max_bpr, device=b.device)
    live = (slot[None, :] < row_len[:, None]).reshape(-1)    # [nbr*max_bpr]
    a = vals[flat_idx.long()].float() * live[:, None, None]
    gathered = b.reshape(K // w, w, N)[flat_col.long()].float()
    prod = torch.einsum("shw,swn->shn", a, gathered).reshape(
        n_block_rows, max_bpr, h, N)
    # a row's slots added one by one in slot order, as the kernel does: a
    # ``sum`` over the slot axis groups its terms by the tensor's width on
    # the CPU, so column panels of B would not give the same bits
    out = prod.new_zeros((n_block_rows, h, N))
    for t in range(max_bpr):
        out += prod[:, t]
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


def bcsr_sddmm_row_loop_ref(dc: torch.Tensor, b: torch.Tensor,
                            flat_idx: torch.Tensor, flat_col: torch.Tensor,
                            n_block_rows: int, nnzb: int, h: int, w: int,
                            out_dtype=None) -> torch.Tensor:
    """dVals through the static schedule: slot t of block-row i computes
    dC[block i] @ B[block flat_col[i * max_bpr + t]]^T into output entry
    ``flat_idx[i * max_bpr + t]``; padding slots compute too and land on the
    sentinel entry ``nnzb`` of an ``[nnzb + 1, h, w]`` buffer, which is
    sliced off.

    dc [M, N] (M multiple of h), b [K, N] (K multiple of w)
    returns [nnzb, h, w]
    """
    M, N = dc.shape
    K, _ = b.shape
    max_bpr = flat_idx.shape[0] // n_block_rows
    rows = torch.arange(n_block_rows, device=dc.device).repeat_interleave(
        max_bpr)
    dc_blocks = dc.reshape(M // h, h, N)[rows].float()       # [S, h, N]
    b_blocks = b.reshape(K // w, w, N)[flat_col.long()].float()
    prod = torch.einsum("shn,swn->shw", dc_blocks, b_blocks)
    out = prod.new_zeros((nnzb + 1, h, w))
    out[flat_idx.long()] = prod          # the sentinel takes any padding slot
    return out[:nnzb].to(out_dtype or dc.dtype)


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


def unpack_ebits(ebits: torch.Tensor, w: int) -> torch.Tensor:
    """The bool element mask ``[..., h, w]`` of ``bcsr_attn.pack_emask``'s
    words ``[..., h, ceil(w / 32)]`` int32 (bit ``c % 32`` of word
    ``c // 32`` is element ``c``)."""
    shift = torch.arange(32, dtype=torch.int32, device=ebits.device)
    bits = (ebits.unsqueeze(-1) >> shift) & 1
    return bits.reshape(*ebits.shape[:-1], -1)[..., :w] != 0


def bcsr_attn_fused_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        emask: torch.Tensor, flat_idx: torch.Tensor,
                        flat_col: torch.Tensor, *, n_block_rows: int,
                        n_block_cols: int, block, scale: float,
                        cap: Optional[float] = None, out_dtype=None,
                        ebits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused block-sparse attention (``bcsr_attn.bcsr_attn_fused``) in
    plain PyTorch, vectorised over (instance, block-row, slot): K, V and the
    element mask are gathered through ``flat_col`` and ``flat_idx`` (a
    padding slot's entry is the sentinel ``nnzb``, an all-zero mask block).
    The kernel's two passes: the row max over every slot (clamped >=
    -1e30); then z = exp(logit - max) where the mask allows it, its row sum
    (clamped >= 1e-30) and z @ V, and the context (z @ V) / sum.

    q [G, Lq, d], k [G, Lk, d], v [G, Lk, dv], emask [nnzb, h, w] 0/1,
    flat_idx / flat_col [nbr * max_bpr]; returns [G, Lq, dv].  ``ebits``,
    when given, is the mask packed one bit per element with the sentinel
    block (``bcsr_attn.pack_emask``), and is read in place of ``emask``.
    """
    G, Lq, d = q.shape
    Lk, dv = v.shape[1], v.shape[2]
    h, w = block
    nbr, nbc = n_block_rows, n_block_cols
    max_bpr = flat_idx.shape[0] // nbr
    qb = F.pad(q.float(), (0, 0, 0, nbr * h - Lq)).reshape(G, nbr, h, d)
    kb = F.pad(k.float(), (0, 0, 0, nbc * w - Lk)).reshape(G, nbc, w, d)
    vb = F.pad(v.float(), (0, 0, 0, nbc * w - Lk)).reshape(G, nbc, w, dv)
    col = flat_col.long().reshape(nbr, max_bpr)
    if ebits is not None:                                # + the sentinel
        em = unpack_ebits(ebits[flat_idx.long()], w)
    else:
        em = F.pad(emask.float(), (0, 0, 0, 0, 0, 1))[flat_idx.long()] != 0
    em = em.reshape(nbr, max_bpr, h, w)
    s = torch.einsum("gihd,gitwd->githw", qb, kb[:, col]) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    logits = torch.where(em, s, NEG_INF)                 # [G, nbr, t, h, w]
    m = logits.amax(dim=(2, 4)).clamp_min(-1e30)         # [G, nbr, h]
    z = torch.where(em, torch.exp(logits - m[:, :, None, :, None]), 0.0)
    denom = z.sum(dim=4).sum(dim=2).clamp_min(1e-30)     # [G, nbr, h]
    ctx = torch.einsum("githw,gitwe->gihe", z, vb[:, col]) / denom[..., None]
    return ctx.reshape(G, nbr * h, dv)[:, :Lq].to(out_dtype or q.dtype)
