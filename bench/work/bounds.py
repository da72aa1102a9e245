"""Each sparse kernel launch's least time on the card, and the launches a
training step or a batch of prompts makes, from the cell's own sizes.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``sddmm_bound`` and
``attn_bound``: each input byte read once, each output byte written once,
two operations a multiply-add of a stored value; the least time is the
larger of bytes over HBM bandwidth and operations over the peak of the
product's dtype (``work.peaks``).
"""
from __future__ import annotations

from bench.work import peaks
from bench.work.count import banded_row_blocks


def _least(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.FLOPS[dtype])


def spmm_bound(nnzb, block, k, n, nbr, dtype, g=1) -> float:
    """Seconds of C[M, N] = A[M, K] @ B[K, N] over ``nnzb`` stored
    ``block`` tiles (B1, B3), for ``g`` instances of one structure: A's
    values and index arrays, B and C, each once."""
    h, w = block
    es = peaks.BYTES[dtype]
    nbytes = g * (nnzb * h * w * es + k * n * es + nbr * h * n * es) \
        + nnzb * 4 + (nbr + 1) * 4
    return _least(nbytes, g * 2.0 * nnzb * h * w * n, dtype)


def sddmm_bound(nnzb, block, m, k, n, dtype, g=1) -> float:
    """Seconds of the stored blocks of X[M, N] @ Y[K, N]^T (B2, B4), every
    block-row and block-col touched: X and Y read once, the blocks written
    once, the two index arrays read."""
    h, w = block
    es = peaks.BYTES[dtype]
    nbytes = g * ((m + k) * n * es + nnzb * h * w * es) + 2 * nnzb * 4
    return _least(nbytes, g * 2.0 * nnzb * h * w * n, dtype)


def attn_bound(nnzb, nbr, max_bpr, block, g, seq, d, dv) -> float:
    """Seconds of one fused block-sparse attention launch (B5) over ``g``
    instances: q, k, v, the element bitmask (one bit an element, the
    sentinel block too) and the schedule read once, the f32 context written
    once; Q K^T and P V once a stored block, at the f32 (3xTF32) peak."""
    h, w = block
    nbytes = (4 * g * seq * (2 * d + 2 * dv) + 4 * (nnzb + 1) * h
              * -(-w // 32) + 8 * nbr * max_bpr)
    flops = g * nnzb * 2.0 * h * w * (d + dv)
    return _least(nbytes, flops, "float32")


def ffn_products(model, tokens: int, train: bool) -> dict:
    """``{"spmm": [...], "sddmm": [...]}``: the least time of each sparse
    FFN product of one pass over ``tokens`` positions (gate and up are
    [d_ff, d_model], down [d_model, d_ff]).  Training adds each product's
    dB = A^T dC (an SpMM over the transpose) and its dvals (an SDDMM)."""
    d, f, n = model["d_model"], model["d_ff"], model["n_layers"]
    ffn = model["ffn"]
    h, w = ffn["block"]
    nnzb, dt = ffn["nnzb"], model["dtype"]
    out = {"spmm": [], "sddmm": []}
    for _ in range(n):
        for m, k in ((f, d), (f, d), (d, f)):
            out["spmm"].append(spmm_bound(nnzb, (h, w), k, tokens, m // h,
                                          dt))
            if train:
                out["spmm"].append(spmm_bound(nnzb, (w, h), m, tokens,
                                              k // w, dt))
                out["sddmm"].append(sddmm_bound(nnzb, (h, w), m, k, tokens,
                                                dt))
    return out


def mask_shape(model, seq: int):
    """``(nnzb, n_block_rows, max_bpr)`` of the banded mask at ``seq``."""
    attn = model["attention"]
    counts = banded_row_blocks(seq, attn["bandwidth"], attn["block"])
    return sum(counts), len(counts), max(counts)


def attn_backward_products(model, rows: int, seq: int) -> dict:
    """The composed backward of block-sparse attention, per layer and row:
    the scores and d(probs) (two SDDMMs over the mask), and the context, dV
    (over the transpose), dQ and dK (over the transpose) (four SpMMs), each
    one launch over the heads, f32 at N = head_dim."""
    attn = model["attention"]
    nnzb, nbr, _ = mask_shape(model, seq)
    g, dh = model["n_heads"], model["head_dim"]
    block = tuple(attn["block"])
    out = {"spmm": [], "sddmm": []}
    for _ in range(model["n_layers"] * rows):
        out["sddmm"] += [sddmm_bound(nnzb, block, seq, seq, dh, "float32",
                                     g)] * 2
        out["spmm"] += [spmm_bound(nnzb, block, seq, dh, nbr, "float32",
                                   g)] * 4
    return out


def train_products(model, rows: int, seq: int) -> dict:
    """Least time of every B1-B4 product of one training step."""
    out = ffn_products(model, rows * seq, train=True)
    if model["attention"]["kind"] == "banded":
        back = attn_backward_products(model, rows, seq)
        for k in out:
            out[k] += back[k]
    return out


def prefill_attn_products(model, rows: int, seq: int) -> list:
    """Least time of each B5 launch of one batch of prompts: one a layer
    over every row's heads, f32."""
    nnzb, nbr, max_bpr = mask_shape(model, seq)
    dh = model["head_dim"]
    one = attn_bound(nnzb, nbr, max_bpr, tuple(model["attention"]["block"]),
                     rows * model["n_heads"], seq, dh, dh)
    return [one] * model["n_layers"]
