"""The frozen work and bound arithmetic against counts made by hand for
both configurations (and ``chip_smoke.py``'s bounds of the same
launches)."""
from __future__ import annotations

import pytest

from bench.core import cells
from bench.work import bounds, count

ATTN = cells.load("attn-prefill").model
FFN = cells.load("ffn-train").model
D, L, V, N = 2048, 24, 32000, 112
PROJ = 4 * D * D                    # q, k, v, o a token a layer
SPARSE = 3 * 2 * N * 128 * 128      # gate, up, down a token a layer


@pytest.mark.parametrize("seq,blocks,widest", [(4096, 528, 32),
                                               (8192, 1584, 33),
                                               (16384, 3696, 33),
                                               (32768, 7920, 33)])
def test_banded_mask_blocks(seq, blocks, widest):
    # block-row i holds min(i + 1, 33) blocks: 4096 / 128 + 1 diagonals
    rows = count.banded_row_blocks(seq, 4096, (128, 128))
    assert sum(rows) == blocks == sum(min(i + 1, 33)
                                      for i in range(seq // 128))
    assert max(rows) == widest


@pytest.mark.parametrize("rows,seq", [(1, 4096), (1, 8192), (3, 32768)])
def test_prefill_flops_by_hand(rows, seq):
    blocks = sum(min(i + 1, 33) for i in range(seq // 128))
    want = rows * (2 * seq * PROJ * L + 4 * 128 * 16 * blocks * 128 * 128 * L
                   + seq * L * SPARSE + 2 * D * V)
    assert count.prefill_flops(ATTN, rows, seq) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("rows,seq", [(12, 1024), (1, 4096)])
def test_train_flops_by_hand(rows, seq):
    tokens = rows * seq
    fwd = (2 * tokens * PROJ * L + 4 * 128 * 16 * rows * seq * (seq + 1)
           // 2 * L + tokens * L * SPARSE + 2 * tokens * D * V)
    assert count.train_step_flops(FFN, rows, seq) == \
        pytest.approx(3 * fwd, rel=1e-12)
    # 8,192 tokens of the banded model: 44.8 TFLOP a step
    assert count.train_step_flops(ATTN, 1, 8192) == \
        pytest.approx(44.80e12, rel=2e-3)


def test_kernel_bounds_match_the_bring_up_table():
    # PERF.md's kernel table: B1 at N = 2048, 0.01362 ms (bytes); B5 at
    # 8,192 and 32,768 tokens, 1.288 and 6.442 ms (operations); the batched
    # f32 products of the attention backward, 0.6442 ms (operations)
    b1 = bounds.spmm_bound(N, (128, 128), 2048, 2048, 64, "bfloat16")
    assert b1 == pytest.approx(0.01362e-3, rel=2e-3)
    for seq, want in ((8192, 1.288e-3), (32768, 6.442e-3)):
        nnzb, nbr, widest = bounds.mask_shape(ATTN, seq)
        got = bounds.attn_bound(nnzb, nbr, widest, (128, 128), 16, seq, 128,
                                128)
        assert got == pytest.approx(want, rel=2e-3)
    assert bounds.spmm_bound(1584, (128, 128), 8192, 128, 64, "float32",
                             16) == pytest.approx(0.6442e-3, rel=2e-3)
    assert bounds.sddmm_bound(1584, (128, 128), 8192, 8192, 128, "float32",
                              16) == pytest.approx(0.6442e-3, rel=2e-3)


def test_launch_lists_of_a_step_and_a_prompt():
    ffn = bounds.train_products(FFN, 1, 4096)
    assert (len(ffn["spmm"]), len(ffn["sddmm"])) == (6 * L, 3 * L)
    attn = bounds.train_products(ATTN, 1, 8192)
    assert (len(attn["spmm"]), len(attn["sddmm"])) == (10 * L, 5 * L)
    batch = bounds.prefill_attn_products(ATTN, 3, 32768)
    assert len(batch) == L
    # one launch over every row's heads: three rows' instances at once
    nnzb, nbr, widest = bounds.mask_shape(ATTN, 32768)
    assert batch[0] == bounds.attn_bound(nnzb, nbr, widest, (128, 128),
                                         48, 32768, 128, 128)
    assert batch[0] == pytest.approx(3 * 6.442e-3, rel=2e-3)
