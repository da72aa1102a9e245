"""The port's CUDA kernels and the model path on the card, against their
plain PyTorch versions.  Every test here is marked ``cuda`` and skips on a
machine without a card; the file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: f32 rtol = atol = 1e-4 (the kernel's FMA order differs from the
plain einsum); bf16 out 1e-2, about one bf16 ulp of the plain f32 result.
B2 and B4 in f32 (3xTF32, whose tensor-core sums truncate over long
contractions) and B5 against the composed path: carve-out 2, 1e-5 x the largest |value|
(ROADMAP C); B5 against its plain version 1e-4 x max|plain|.
The f32 training step: loss rtol 1e-5, every gradient max|diff| <= 1e-4 x
its max|grad| (f32 sums of a few hundred products in another order)."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core import bcsr as tb
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels import bcsr_attn, bcsr_spmm, ref
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.train import loop

SHAPES = [                       # tests/test_kernels.py:19
    ((64, 64), (8, 8), 0.5),
    ((128, 256), (16, 32), 0.3),
    ((256, 128), (32, 16), 0.15),
    ((96, 160), (16, 16), 0.4),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nnz_stream_kernel_on_card(card, dtype):
    dt, tol = getattr(torch, dtype), (1e-4 if dtype == "float32" else 1e-2)
    for shape, block, density in SHAPES:
        ta = tb.random_bcsr(0, shape, block, density)
        arrays, meta = tops.prepare(ta, dt, device=card)
        for n in (8, 64, 100):
            b = torch.from_numpy(np.random.default_rng(n).standard_normal(
                (shape[1], n)).astype(np.float32)).to(card, dt)
            before = bcsr_spmm.LAUNCHES["nnz_stream"]
            got = tops.spmm(arrays, meta, b)
            assert bcsr_spmm.LAUNCHES["nnz_stream"] == before + 1
            want = ref.bcsr_spmm_ref(arrays.vals, arrays.row_ids,
                                     arrays.col_ids, b, meta.n_block_rows,
                                     out_dtype=torch.float32).to(dt)
            torch.testing.assert_close(got.float()[:shape[0]],
                                       want.float()[:shape[0]], rtol=tol,
                                       atol=tol)


def _with_empty_row(h, w, dtype, device, seed=0):
    """A 3 x 4 grid of h x w blocks whose block-row 1 is empty: B1's
    operands (vals, row_ids, col_ids, rowptr) and B3's static schedule of
    the same entries (flat_idx, flat_col, row_len; max_bpr 3)."""
    cols = [[0, 2, 3], [], [1, 3]]
    rng = np.random.default_rng(seed)
    nnzb = sum(map(len, cols))
    vals = torch.from_numpy(rng.standard_normal((nnzb, h, w)).astype(
        np.float32)).to(device, dtype)
    row_ids = [i for i, c in enumerate(cols) for _ in c]
    rowptr = np.cumsum([0] + [len(c) for c in cols])
    flat_idx = [rowptr[i] + t if t < len(c) else 0
                for i, c in enumerate(cols) for t in range(3)]
    flat_col = [c[t] if t < len(c) else 0
                for c in cols for t in range(3)]

    def i32(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)
    return (vals, i32(row_ids), i32(sum(cols, [])), i32(rowptr),
            i32(flat_idx), i32(flat_col), i32([len(c) for c in cols]))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 16, 32, 128])
@pytest.mark.parametrize("h", [8, 16, 32, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_tile_kernels_on_card(card, dtype, h, w):
    """B1 and B3 (one tile routine, ``csrc/spmm_tile.cuh``) on blocks that
    fill or cut the mma tiles (h, w in 8 .. 128), N from 1 to 2048 (the
    decode and training row blocks, ragged N edges), B row-major and as the
    x^T view, at an aligned base and one element off (the narrow copy
    widths): each against its plain version (f32 rtol = atol = 1e-4, bf16
    1e-2), two calls bit-equal, B3 bit-equal to B1, the empty block-row all
    zeros."""
    dt, tol = getattr(torch, dtype), (1e-4 if dtype == "float32" else 1e-2)
    vals, row_ids, col_ids, rowptr, flat_idx, flat_col, row_len = \
        _with_empty_row(h, w, dt, card)
    rng = np.random.default_rng(h * w)
    for n in (1, 4, 8, 33, 64, 100, 2048):
        for view in (False, True):
            for offset in (0, 1):
                flat = torch.from_numpy(rng.standard_normal(
                    4 * w * n + offset).astype(np.float32)).to(card, dt)
                b = (flat[offset:].view(n, 4 * w).T if view
                     else flat[offset:].view(4 * w, n))
                before = dict(bcsr_spmm.LAUNCHES)
                got, again = (bcsr_spmm.bcsr_spmm_nnz_stream(
                    vals, row_ids, col_ids, b, 3, rowptr=rowptr)
                    for _ in range(2))
                b3 = bcsr_spmm.bcsr_spmm_row_loop(vals, flat_idx, flat_col,
                                                  row_len, b, 3)
                assert bcsr_spmm.LAUNCHES["nnz_stream"] == \
                    before["nnz_stream"] + 2
                assert bcsr_spmm.LAUNCHES["row_loop"] == \
                    before["row_loop"] + 1
                want = ref.bcsr_spmm_ref(vals, row_ids, col_ids, b, 3,
                                         out_dtype=torch.float32).to(dt)
                case = (n, view, offset, bcsr_spmm._launch_config(vals, b))
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol, msg=str(case))
                assert torch.equal(got, again), case
                assert torch.equal(got, b3), case
                assert bool((got[h:2 * h] == 0).all()), case


@pytest.mark.cuda
@pytest.mark.parametrize("block", [(8, 8), (128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_tile_long_rows_on_card(card, dtype, block):
    """Block-rows of 300 entries, more than two windows of the entry ids the
    tile routine stages at once (``spmm_tile::kWin`` = 128), so the window
    refill runs: B1 and B3 against the plain version (f32 rtol = atol =
    1e-4, bf16 1e-2), two calls bit-equal, B3 bit-equal to B1, both B
    layouts, at an aligned base and one element off."""
    dt, tol = getattr(torch, dtype), (1e-4 if dtype == "float32" else 1e-2)
    h, w = block
    ta = tb.random_bcsr(0, (2 * h, 300 * w), block, 1.0)
    arrays, meta = tops.prepare(ta, dt, device=card)
    assert meta.max_bpr == 300
    rng = np.random.default_rng(h)
    for n in (4, 64, 100):
        for view in (False, True):
            for offset in (0, 1):
                flat = torch.from_numpy(rng.standard_normal(
                    300 * w * n + offset).astype(np.float32)).to(card, dt)
                b = (flat[offset:].view(n, 300 * w).T if view
                     else flat[offset:].view(300 * w, n))
                got, again = (bcsr_spmm.bcsr_spmm_nnz_stream(
                    arrays.vals, arrays.row_ids, arrays.col_ids, b, 2,
                    rowptr=arrays.rowptr) for _ in range(2))
                b3 = bcsr_spmm.bcsr_spmm_row_loop(
                    arrays.vals, arrays.flat_idx, arrays.flat_col,
                    arrays.row_len, b, 2)
                want = ref.bcsr_spmm_ref(arrays.vals, arrays.row_ids,
                                         arrays.col_ids, b, 2,
                                         out_dtype=torch.float32).to(dt)
                case = (n, view, offset,
                        bcsr_spmm._launch_config(arrays.vals, b))
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol, msg=str(case))
                assert torch.equal(got, again), case
                assert torch.equal(got, b3), case


@pytest.mark.cuda
def test_smoke_model_decode_kernel_matches_plain(card):
    """One f32 decode step of ``smat-ffn-1.3b:smoke`` through the kernel and
    through the plain version, same weights: logits within 1e-4, and the
    kernel launched 3 times per layer."""
    cfg = dataclasses.replace(get_config("smat-ffn-1.3b:smoke"),
                              dtype="float32")
    model = T.init_params(cfg, seed=0, device=card)
    toks = torch.tensor([3, 7], device=card)
    logits = {}
    with torch.inference_mode():
        for backend in ("nnz_stream", "xla"):
            cfg_b = dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
                cfg.ffn_sparsity, backend=backend))
            before = bcsr_spmm.LAUNCHES["nnz_stream"]
            logits[backend], _ = T.decode_step(
                cfg_b, model, T.init_cache(cfg_b, 2, 16, device=card), toks,
                0)
            launched = bcsr_spmm.LAUNCHES["nnz_stream"] - before
            assert launched == (3 * cfg.n_layers if backend == "nnz_stream"
                                else 0)
    torch.testing.assert_close(logits["nnz_stream"], logits["xla"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sddmm_kernel_on_card(card, dtype):
    """B2 against its plain version: odd blocks, ragged N, and dC / B both
    row-major and as the transposed views training passes."""
    dt, tol = getattr(torch, dtype), (1e-4 if dtype == "float32" else 1e-2)
    rng = np.random.default_rng(0)
    for shape, block, density in SHAPES:
        ta = tb.random_bcsr(0, shape, block, density)
        arrays, meta = tops.prepare(ta, dt, device=card)
        h, w = block
        for n in (8, 33, 100):
            for view in (False, True):
                x, y = (torch.from_numpy(rng.standard_normal(
                    (n, m) if view else (m, n)).astype(np.float32)).to(
                        card, dt) for m in (shape[0], shape[1]))
                if view:
                    x, y = x.T, y.T
                before = bcsr_spmm.LAUNCHES["sddmm"]
                got = bcsr_spmm.bcsr_sddmm(x, y, arrays.row_ids,
                                           arrays.col_ids, h, w)
                assert bcsr_spmm.LAUNCHES["sddmm"] == before + 1
                want = ref.bcsr_sddmm_ref(x, y, arrays.row_ids,
                                          arrays.col_ids, h, w,
                                          out_dtype=torch.float32).to(dt)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)


def _strided(rng, rows, n, dt, device, view, offset):
    """A [rows, n] operand: row-major, or the transposed view training
    passes (its row axis contiguous), ``offset`` elements into its storage
    (a misaligned base: a narrower copy)."""
    flat = torch.from_numpy(rng.standard_normal(rows * n + offset).astype(
        np.float32)).to(device, dt)[offset:]
    return flat.view(n, rows).T if view else flat.view(rows, n)


def _held_sddmm(got, want, case=None):
    """B2 against its plain version: bf16 rtol = atol = 1e-2 (about one
    ulp); f32 carve-out 2, max|diff| <= 1e-5 x max|plain|."""
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2, msg=str(case))
    else:
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (case, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b_view", [False, True])
@pytest.mark.parametrize("dc_view", [False, True])
@pytest.mark.parametrize("block", [(16, 16), (24, 40), (128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sddmm_tile_on_card(card, dtype, block, dc_view, b_view):
    """B2 (the tile routine of ``csrc/sddmm_tile.cuh``) with each operand
    row-major or as the transposed view (both majorities of each, in every
    pairing), on blocks that fill or cut the 64 x 64 tile, ragged N (from
    1 to 2048, with partial N chunks), at an aligned base and one element
    off (the narrow copy widths): against its plain version, two calls
    bit-equal, one launch counted each.  bf16: rtol = atol = 1e-2, about
    one ulp.  f32 (3xTF32, whose tensor-core sums truncate): carve-out 2,
    max|diff| <= 1e-5 x max|plain| (ROADMAP C): over N = 2048 terms an
    element near zero is off by more than 1e-4 of itself."""
    dt = getattr(torch, dtype)
    h, w = block
    ta = tb.random_bcsr(1, (4 * h, 5 * w), block, 0.4).ensure_nonempty_rows()
    row_ids = torch.from_numpy(ta.row_ids).to(card)
    col_ids = torch.from_numpy(ta.col_ids).to(card)
    rng = np.random.default_rng(h + w)
    for n in (1, 8, 33, 100, 2048):
        for offset in (0, 1):
            dc = _strided(rng, 4 * h, n, dt, card, dc_view, offset)
            b = _strided(rng, 5 * w, n, dt, card, b_view, offset)
            before = bcsr_spmm.LAUNCHES["sddmm"]
            got, again = (bcsr_spmm.bcsr_sddmm(dc, b, row_ids, col_ids, h, w)
                          for _ in range(2))
            assert bcsr_spmm.LAUNCHES["sddmm"] == before + 2
            want = ref.bcsr_sddmm_ref(dc, b, row_ids, col_ids, h, w,
                                      out_dtype=torch.float32).to(dt)
            case = (n, offset, bcsr_spmm.sddmm_launch_config(
                n, h, w, dt, dc.data_ptr(), b.data_ptr(), *dc.stride(),
                *b.stride()))
            _held_sddmm(got, want, case)
            assert torch.equal(got, again), case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sddmm_main_path_widths_on_card(card, dtype):
    """B2 at the widths the main paths run it: the FFN backward's 112
    blocks of 128x128 at N = 2048 with dC and B as the transposed views
    (bf16), and the attention backward's banded(4096) mask at L = 8192, N
    = 128, row-major Q and K (f32, where it also meets rtol = atol =
    1e-4); against its plain version (``_held_sddmm``), bit-stable."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    if dtype == "bfloat16":
        ta = tb.random_bcsr_exact(3, (8192, 2048), (128, 128), 112)
        row_ids = torch.from_numpy(ta.row_ids).to(card)
        col_ids = torch.from_numpy(ta.col_ids).to(card)
        dc = _strided(rng, 8192, 2048, dt, card, True, 0)
        b = _strided(rng, 2048, 2048, dt, card, True, 0)
    else:
        mt = A.mask_tensors(A.banded(4096), 8192, (128, 128), card)
        row_ids, col_ids = mt.arrays.row_ids, mt.arrays.col_ids
        dc = _strided(rng, 8192, 128, dt, card, False, 0)
        b = _strided(rng, 8192, 128, dt, card, False, 0)
    got, again = (bcsr_spmm.bcsr_sddmm(dc, b, row_ids, col_ids, 128, 128)
                  for _ in range(2))
    want = ref.bcsr_sddmm_ref(dc, b, row_ids, col_ids, 128, 128,
                              out_dtype=torch.float32).to(dt)
    _held_sddmm(got, want)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)


def _train_grads(cfg, model, batch, backend):
    cfg_b = dataclasses.replace(cfg, ffn_sparsity=dataclasses.replace(
        cfg.ffn_sparsity, backend=backend))
    for p in model.parameters():
        p.grad = None
    loss, _ = T.train_loss(cfg_b, model, batch, remat="none")
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}


@pytest.mark.cuda
def test_smoke_train_step_kernel_matches_plain(card):
    """One f32 training step of ``smat-ffn-1.3b:smoke`` through the kernels
    and through the plain versions, same weights: B1 runs 6 times a layer
    (3 forward, 3 dB), B2 3 times (dvals); loss and gradients agree."""
    cfg = dataclasses.replace(get_config("smat-ffn-1.3b:smoke"),
                              dtype="float32")
    model = T.init_params(cfg, seed=0, device=card)
    batch = loop.batch_to_device(
        make_batch(cfg, ShapeCell("t", "train", 32, 2), 0), card)
    before = dict(bcsr_spmm.LAUNCHES)
    loss_k, grads_k = _train_grads(cfg, model, batch, "nnz_stream")
    launched = {k: bcsr_spmm.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"nnz_stream": 6 * cfg.n_layers, "row_loop": 0,
                        "sddmm": 3 * cfg.n_layers, "sddmm_row_loop": 0}
    loss_p, grads_p = _train_grads(cfg, model, batch, "xla")
    assert bcsr_spmm.LAUNCHES["sddmm"] == before["sddmm"] + 3 * cfg.n_layers
    np.testing.assert_allclose(loss_k, loss_p, rtol=1e-5)
    for name, g in grads_p.items():
        err = (grads_k[name] - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_loop_kernels_on_card(card, dtype):
    """B3 and B4 against their plain versions (which read the same schedule
    arrays): odd blocks, max_bpr of 1 and of many, ragged N, operands
    row-major and as transposed views.  B3: f32 rtol = atol = 1e-4, bf16
    1e-2.  B4 (B2's tile routine): bf16 1e-2, f32 carve-out 2 (B2's
    3xTF32, ``_held_sddmm``); two calls bit-equal, and bit-equal to B2 on
    the same entries."""
    dt, tol = getattr(torch, dtype), (1e-4 if dtype == "float32" else 1e-2)
    rng = np.random.default_rng(1)
    operands = [tb.random_bcsr(0, s, b, d) for s, b, d in SHAPES]
    operands.append(tb.random_bcsr_exact(0, (64, 64), (8, 8), 8))
    for ta in operands:
        arrays, meta = tops.prepare(ta, dt, device=card)
        h, w = meta.block
        for n in (8, 33, 100):
            for view in (False, True):
                x, dc = (torch.from_numpy(rng.standard_normal(
                    (n, m) if view else (m, n)).astype(np.float32)).to(
                        card, dt) for m in (meta.n_block_cols * w,
                                            meta.n_block_rows * h))
                if view:
                    x, dc = x.T, dc.T
                before = dict(bcsr_spmm.LAUNCHES)
                got = bcsr_spmm.bcsr_spmm_row_loop(
                    arrays.vals, arrays.flat_idx, arrays.flat_col,
                    arrays.row_len, x, meta.n_block_rows)
                want = ref.bcsr_spmm_row_loop_ref(
                    arrays.vals, arrays.flat_idx, arrays.flat_col,
                    arrays.row_len, x, meta.n_block_rows,
                    out_dtype=torch.float32).to(dt)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
                got, again = (bcsr_spmm.bcsr_sddmm_row_loop(
                    dc, x, arrays.sddmm_flat_idx, arrays.flat_col,
                    meta.n_block_rows, meta.nnzb, h, w) for _ in range(2))
                want = ref.bcsr_sddmm_row_loop_ref(
                    dc, x, arrays.sddmm_flat_idx, arrays.flat_col,
                    meta.n_block_rows, meta.nnzb, h, w,
                    out_dtype=torch.float32).to(dt)
                _held_sddmm(got, want, (n, view))
                assert torch.equal(got, again)
                assert torch.equal(got, bcsr_spmm.bcsr_sddmm(
                    dc, x, arrays.row_ids, arrays.col_ids, h, w))
                assert bcsr_spmm.LAUNCHES["row_loop"] == \
                    before["row_loop"] + 1
                assert bcsr_spmm.LAUNCHES["sddmm_row_loop"] == \
                    before["sddmm_row_loop"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("block", [(16, 16), (24, 40), (128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sddmm_row_loop_padding_slots_on_card(card, dtype, block):
    """B4 on a schedule that is mostly padding: 8 block-rows, row 0 with
    300 entries (LONG_ROWS), row 1 empty, the others 1 or 2, so max_bpr is
    300, about 8x the mean, and 2,091 of 2,400 slots hold the sentinel.
    Padding slots write nothing, so the result is [nnzb, h, w] and equals
    B2 on the same entries bit for bit; against its plain version (bf16
    1e-2, f32 carve-out 2), two calls bit-equal, one launch counted each.
    dC and B each row-major or as the transposed view (both majorities of
    each), at an aligned base and one element off; N from 1 to 2048."""
    dt = getattr(torch, dtype)
    h, w = block
    rng = np.random.default_rng(h + w)
    cols = [list(range(300)), []] + [
        sorted(rng.choice(300, 1 + i % 2, replace=False).tolist())
        for i in range(6)]
    row_ids = np.asarray([i for i, c in enumerate(cols) for _ in c],
                         np.int32)
    col_ids = np.asarray(sum(cols, []), np.int32)
    nbr, nnzb = len(cols), len(row_ids)
    flat_idx, flat_col = tops._sddmm_row_loop_schedule(row_ids, col_ids,
                                                       nbr, 300)
    assert (flat_idx == nnzb).sum() == nbr * 300 - nnzb == 2091
    r, c, fi, fc = (torch.from_numpy(a).to(card)
                    for a in (row_ids, col_ids, flat_idx, flat_col))
    for n in (1, 33, 2048):
        for dc_view in (False, True):
            for b_view in (False, True):
                for offset in (0, 1):
                    dc = _strided(rng, nbr * h, n, dt, card, dc_view, offset)
                    b = _strided(rng, 300 * w, n, dt, card, b_view, offset)
                    before = bcsr_spmm.LAUNCHES["sddmm_row_loop"]
                    got, again = (bcsr_spmm.bcsr_sddmm_row_loop(
                        dc, b, fi, fc, nbr, nnzb, h, w) for _ in range(2))
                    assert bcsr_spmm.LAUNCHES["sddmm_row_loop"] == \
                        before + 2
                    want = ref.bcsr_sddmm_row_loop_ref(
                        dc, b, fi, fc, nbr, nnzb, h, w,
                        out_dtype=torch.float32).to(dt)
                    case = (n, dc_view, b_view, offset,
                            bcsr_spmm.sddmm_launch_args(dc, b, h, w, dt))
                    assert got.shape == (nnzb, h, w), case
                    _held_sddmm(got, want, case)
                    assert torch.equal(got, again), case
                    assert torch.equal(got, bcsr_spmm.bcsr_sddmm(
                        dc, b, r, c, h, w)), case


def _heads(rng, G, rows, n, dt, device, layout):
    """A [G, rows, n] operand: contiguous, the model's folded heads (a
    view of one [1, rows, G, n] tensor: batch stride n, row stride G * n),
    or the x^T view of a [G, n, rows] tensor (rows contiguous)."""
    if layout == "xT":
        t = rng.standard_normal((G, n, rows)).astype(np.float32)
        return torch.from_numpy(t).to(device, dt).transpose(1, 2)
    if layout == "heads":
        t = rng.standard_normal((1, rows, G, n)).astype(np.float32)
        return torch.from_numpy(t).to(device, dt).transpose(1, 2)[0]
    t = rng.standard_normal((G, rows, n)).astype(np.float32)
    return torch.from_numpy(t).to(device, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "heads", "xT"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_kernels_equal_single_launches_on_card(card, dtype, layout):
    """B1-B4 over G = 3 instances in one launch (counted once): bit-equal
    to G single launches on the instances' views, whatever the dense
    operands' layout (the folded heads are strided views), and within
    tolerance of the batched plain versions (f32 rtol = atol = 1e-4; bf16
    1e-2); B3 bit-equal to B1 and B4 to B2."""
    dt, tol = getattr(torch, dtype), (1e-4 if dtype == "float32" else 1e-2)
    rng = np.random.default_rng(3)
    G = 3
    for shape, block, density in SHAPES[:3]:
        arrays, meta = tops.prepare(tb.random_bcsr(0, shape, block, density),
                                    dt, device=card)
        h, w = meta.block
        nbr, M, K = meta.n_block_rows, meta.n_block_rows * h, \
            meta.n_block_cols * w
        vals = torch.from_numpy(rng.standard_normal(
            (G, *arrays.vals.shape)).astype(np.float32)).to(card, dt)
        for n in (8, 100):
            b = _heads(rng, G, K, n, dt, card, layout)
            dc = _heads(rng, G, M, n, dt, card, layout)
            calls = {
                "nnz_stream": lambda s: bcsr_spmm.bcsr_spmm_nnz_stream(
                    vals[s], arrays.row_ids, arrays.col_ids, b[s], nbr,
                    rowptr=arrays.rowptr),
                "row_loop": lambda s: bcsr_spmm.bcsr_spmm_row_loop(
                    vals[s], arrays.flat_idx, arrays.flat_col,
                    arrays.row_len, b[s], nbr),
                "sddmm": lambda s: bcsr_spmm.bcsr_sddmm(
                    dc[s], b[s], arrays.row_ids, arrays.col_ids, h, w),
                "sddmm_row_loop": lambda s: bcsr_spmm.bcsr_sddmm_row_loop(
                    dc[s], b[s], arrays.sddmm_flat_idx, arrays.flat_col,
                    nbr, meta.nnzb, h, w)}
            plain = {
                "nnz_stream": lambda: ref.bcsr_spmm_ref(
                    vals, arrays.row_ids, arrays.col_ids, b, nbr,
                    out_dtype=torch.float32),
                "sddmm": lambda: ref.bcsr_sddmm_ref(
                    dc, b, arrays.row_ids, arrays.col_ids, h, w,
                    out_dtype=torch.float32)}
            plain["row_loop"] = plain["nnz_stream"]
            plain["sddmm_row_loop"] = plain["sddmm"]
            got = {}
            for name, call in calls.items():
                case = (shape, n, layout, name)
                before = dict(bcsr_spmm.LAUNCHES)
                got[name] = call(slice(None))
                after = dict(bcsr_spmm.LAUNCHES)
                assert after == {**before, name: before[name] + 1}, case
                singles = torch.stack([call(g) for g in range(G)])
                assert torch.equal(got[name], singles), case
                torch.testing.assert_close(
                    got[name].float(), plain[name]().to(dt).float(),
                    rtol=tol, atol=tol, msg=str(case))
            assert torch.equal(got["row_loop"], got["nnz_stream"])
            assert torch.equal(got["sddmm_row_loop"], got["sddmm"])


@pytest.mark.cuda
def test_smoke_train_step_row_loop_with_reorder_matches_plain(card):
    """One f32 training step of ``smat-ffn-1.3b:smoke`` with
    ``backend="row_loop"`` and the weights reordered (jaccard): B3 runs 3
    times a layer, B1 3 (dB), B4 3 (dvals); loss and gradients agree with
    the plain versions."""
    base = get_config("smat-ffn-1.3b:smoke")
    cfg = dataclasses.replace(base, dtype="float32",
                              ffn_sparsity=dataclasses.replace(
                                  base.ffn_sparsity, reorder="jaccard"))
    model = T.init_params(cfg, seed=0, device=card)
    batch = loop.batch_to_device(
        make_batch(cfg, ShapeCell("t", "train", 32, 2), 0), card)
    before = dict(bcsr_spmm.LAUNCHES)
    loss_k, grads_k = _train_grads(cfg, model, batch, "row_loop")
    launched = {k: bcsr_spmm.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"nnz_stream": 3 * cfg.n_layers,
                        "row_loop": 3 * cfg.n_layers, "sddmm": 0,
                        "sddmm_row_loop": 3 * cfg.n_layers}
    loss_p, grads_p = _train_grads(cfg, model, batch, "xla")
    np.testing.assert_allclose(loss_k, loss_p, rtol=1e-5)
    for name, g in grads_p.items():
        err = (grads_k[name] - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("block,d", [((16, 16), 32), ((32, 32), 64),
                                     ((64, 64), 128), ((128, 128), 256)])
def test_attn_fused_kernel_on_card(card, block, d):
    """B5 against its plain version, f32: max|diff| <= 1e-4 x max|plain|
    (FMA order, expf); ragged L, cap on and off, the three mask kinds; two
    launches bit-equal."""
    masks = (A.banded(100), A.local_global(64, 20), A.blockwise_causal())
    for L in (61, 1000):
        for mask in masks:
            mt = A.mask_tensors(mask, L, block, card)
            rng = np.random.default_rng(L)
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (3, L, d)).astype(np.float32)).to(card) for _ in range(3))
            for cap in (None, 30.0):
                args = (q, k, v, mt.emask, mt.arrays.sddmm_flat_idx,
                        mt.arrays.flat_col)
                kw = dict(n_block_rows=mt.meta.n_block_rows,
                          n_block_cols=mt.meta.n_block_cols, block=block,
                          scale=d ** -0.5, cap=cap)
                before = bcsr_attn.LAUNCHES["attn_fused"]
                got = bcsr_attn.bcsr_attn_fused(*args, **kw)
                again = bcsr_attn.bcsr_attn_fused(*args, **kw)
                assert bcsr_attn.LAUNCHES["attn_fused"] == before + 2
                want = ref.bcsr_attn_fused_ref(*args, **kw)
                scale = want.abs().max().item()
                assert (got - want).abs().max().item() <= 1e-4 * scale
                assert torch.equal(got, again)


@pytest.mark.cuda
def test_smoke_attention_train_step_kernels_match_plain(card):
    """One f32 training step of ``smat-attn-1.3b:smoke`` at 64 tokens
    (banded(32) in 16x16 blocks: sparse) through B5 and the kernels, and
    through the plain path (attention and FFN on ``xla``): B5 once a layer,
    loss rtol 1e-5, every gradient within 1e-4 x its max|grad|."""
    base = get_config("smat-attn-1.3b:smoke")
    cfg = dataclasses.replace(base, dtype="float32")
    plain = dataclasses.replace(
        cfg, ffn_sparsity=dataclasses.replace(cfg.ffn_sparsity,
                                              backend="xla"),
        attn_sparsity=dataclasses.replace(cfg.attn_sparsity, backend="xla"))
    model = T.init_params(cfg, seed=0, device=card)
    batch = loop.batch_to_device(
        make_batch(cfg, ShapeCell("t", "train", 64, 2), 0), card)
    before = bcsr_attn.LAUNCHES["attn_fused"]
    loss_k, grads_k = _train_grads(cfg, model, batch, "nnz_stream")
    assert bcsr_attn.LAUNCHES["attn_fused"] == before + cfg.n_layers
    loss_p, grads_p = _train_grads(plain, model, batch, "xla")
    assert bcsr_attn.LAUNCHES["attn_fused"] == before + cfg.n_layers
    np.testing.assert_allclose(loss_k, loss_p, rtol=1e-5)
    for name, g in grads_p.items():
        err = (grads_k[name] - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("block,d", [((16, 16), 32), ((128, 128), 128)])
def test_attn_fused_reads_the_bitmask_on_card(card, block, d):
    """B5 fed the mask's cached bits (``mask_tensors(...).ebits``, as the
    model calls it) equals B5 packing ``emask`` itself, bit for bit, and
    its plain version reading the f32 mask within 1e-4 x max|plain|; and
    it stays within carve-out 2 (1e-5 x max|composed|) of the composed path
    on the card's kernels (B2 -> block_softmax -> B1), which divides by the
    denominator before the product with V.  The 16x16 blocks of the
    ``:smoke`` model and the 128x128 blocks of the full width; ragged L."""
    L = 1000 if block[0] == 16 else 2000
    mask = A.banded(200 if block[0] == 16 else 700)
    mt = A.mask_tensors(mask, L, block, card)
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, L, d)).astype(
        np.float32)).to(card) for _ in range(3))
    args = (q, k, v, mt.emask, mt.arrays.sddmm_flat_idx, mt.arrays.flat_col)
    kw = dict(n_block_rows=mt.meta.n_block_rows,
              n_block_cols=mt.meta.n_block_cols, block=block,
              scale=d ** -0.5)
    got = bcsr_attn.bcsr_attn_fused(*args, ebits=mt.ebits, **kw)
    assert torch.equal(got, bcsr_attn.bcsr_attn_fused(*args, **kw))
    want = ref.bcsr_attn_fused_ref(*args, **kw)
    assert (got - want).abs().max().item() <= \
        1e-4 * want.abs().max().item()
    comp = A._composed_heads(q, k, v, A.AttnSparsitySpec(
        mask=mask, block=block, backend="nnz_stream"), d ** -0.5, None)
    assert (got - comp).abs().max().item() <= \
        1e-5 * comp.abs().max().item()


def _paged_cfg(paged, mask=None):
    cfg = get_config("smat-attn-1.3b:smoke")
    kw = {"paged_decode": paged}
    if mask is not None:
        kw["mask"] = mask
    return dataclasses.replace(cfg, dtype="float32", attn_sparsity=(
        dataclasses.replace(cfg.attn_sparsity, **kw)))


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [A.banded(24), A.local_global(16, 8),
                                  A.blockwise_causal()])
def test_paged_decode_equals_its_full_table_on_card(card, mask):
    """The paged decode over the mask's page table equals, bit for bit in
    float32, the same call over the full page table, at every position of
    a 64-slot cache (block 16), on the card as on the CPU."""
    from repro_torch.models import layers as L
    cfg = _paged_cfg("force", mask)
    pages, live = A.decode_page_tensors(L._sparse_mask(cfg, None), 64,
                                        (16, 16), card)
    full = torch.arange(4, device=card).expand(pages.shape[0], -1)
    full = full.contiguous()
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((3, 1, cfg.n_heads, cfg.head_dim), generator=g,
                    device=card)
    kc, vc = (torch.randn((3, 64, cfg.n_kv_heads, cfg.head_dim),
                          generator=g, device=card) for _ in range(2))
    for pos in range(64):
        got = L._paged_decode(cfg, q, kc, vc, pos, None, None, 0.25,
                              pages=pages, live=live)
        want = L._paged_decode(cfg, q, kc, vc, pos, None, None, 0.25,
                               pages=full, live=torch.ones_like(
                                   full, dtype=torch.bool))
        assert torch.equal(got, want), f"pos {pos}"


@pytest.mark.cuda
def test_paged_engine_matches_off_on_card(card):
    """A float32 smat-attn-1.3b:smoke engine (cache 64: 3 of 4 pages a step)
    through paged KV and through the dense bias ("off"): equal greedy
    streams, one decode signature each."""
    from repro_torch.serve.engine import Request, ServeEngine
    model = T.init_params(_paged_cfg("auto"), seed=0, device=card)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n, dtype=np.int32)
               for n in (9, 3, 14, 6, 11)]
    streams = {}
    for mode in ("auto", "off"):
        eng = ServeEngine(_paged_cfg(mode), model, n_slots=2, cache_len=64,
                          device=card)
        assert eng.paged_kv.report()["groups"][0]["paged"] == (mode == "auto")
        streams[mode] = {}
        for rid, tok in eng.generate([Request(i, p, max_new_tokens=5)
                                      for i, p in enumerate(prompts)]):
            streams[mode].setdefault(rid, []).append(tok)
        assert eng.step_sentinel.count == 1
    assert streams["auto"] == streams["off"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["nnz_stream", "row_loop", "auto"])
def test_sharded_spmm_on_card(card, dtype, backend):
    """The partitioned product through the kernels (``launch.dist_spmm``,
    in-process, S = 4 over a ragged structure): against the unsharded
    product (f32 1e-4, bf16 1e-2), chunked == unchunked bit for bit in the
    forward and both gradients, and S x chunks spmm-family launches a
    forward, S dB (B1) and S dvals (B2 or B4) launches a backward."""
    from repro_torch.launch import dist_spmm
    dt, tol = getattr(torch, dtype), (1e-4 if dtype == "float32" else 1e-2)
    a = tb.random_bcsr(0, (23 * 16 + 5, 160), (16, 16), 0.3)
    arrays, smeta = dist_spmm.prepare_sharded(a, 4, dtype=dt, device=card)
    arrays0, meta0 = tops.prepare(a, dt, device=card)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (160, 64)).astype(np.float32)).to(card, dt)
    weight = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (a.shape[0], 64)).astype(np.float32)).to(card, dt)

    def run(n_chunks):
        vals = arrays.vals.clone().requires_grad_()
        bb = b.clone().requires_grad_()
        before = dict(bcsr_spmm.LAUNCHES)
        out = dist_spmm.spmm_sharded(arrays._replace(vals=vals), smeta, bb,
                                     backend=backend, n_chunks=n_chunks)
        fwd = {k: v - before[k] for k, v in bcsr_spmm.LAUNCHES.items()}
        out.backward(weight)
        total = {k: v - before[k] for k, v in bcsr_spmm.LAUNCHES.items()}
        return (out.detach(), vals.grad, bb.grad), fwd, total

    base, fwd, total = run(1)
    want = tops.spmm(arrays0, meta0, b)
    torch.testing.assert_close(base[0].float(), want.float(), rtol=tol,
                               atol=tol)
    assert fwd["nnz_stream"] + fwd["row_loop"] == 4
    assert total["nnz_stream"] + total["row_loop"] == 8
    assert total["sddmm"] + total["sddmm_row_loop"] == 4
    for n_chunks in (2, 4):
        got, fwd, _ = run(n_chunks)
        assert fwd["nnz_stream"] + fwd["row_loop"] == 4 * n_chunks
        for g, w in zip(got, base):
            assert torch.equal(g, w), n_chunks


# the static analyzer's mirrors (``analysis.workspace``) against the
# libraries' own queries, and B5's shared-memory boundary
SPMM_LIBS = [("bcsr_spmm", "bcsr_spmm_nnz_stream"),
             ("bcsr_spmm_row_loop", "bcsr_spmm_row_loop")]
SDDMM_LIBS = [("bcsr_sddmm", "bcsr_sddmm"),
              ("bcsr_sddmm_row_loop", "bcsr_sddmm_row_loop")]


@pytest.mark.cuda
@pytest.mark.parametrize("source,symbol", SPMM_LIBS + SDDMM_LIBS,
                         ids=[s for s, _ in SPMM_LIBS + SDDMM_LIBS])
def test_smem_queries_equal_the_formulas_on_card(card, source, symbol):
    """Every compiled instantiation: ``<kernel>_smem_bytes`` (the C++
    ``Layout::kSmemBytes``) == the Python formula, exactly."""
    from repro_torch.analysis import workspace as ws
    q = bcsr_spmm.query
    for code, dt in ((0, "float32"), (1, "bfloat16")):
        if (source, symbol) in SPMM_LIBS:
            for bm in ws.SPMM_ROW_BLOCKS:
                assert q(source, f"{symbol}_threads", bm) == \
                    ws.spmm_threads(bm)
                for bn in bcsr_spmm.SPMM_TILES:
                    for km in (0, 1):
                        assert q(source, f"{symbol}_smem_bytes", code, bm,
                                 bn, km) == \
                            ws.spmm_smem_bytes(dt, bm, bn, bool(km))
            assert q(source, f"{symbol}_smem_bytes", code, 64, 64, 0) == -1
        else:
            assert q(source, f"{symbol}_threads") == ws.SDDMM_THREADS
            for ak in (0, 1):
                for bk in (0, 1):
                    assert q(source, f"{symbol}_smem_bytes", code, ak,
                             bk) == ws.sddmm_smem_bytes(dt, bool(ak),
                                                        bool(bk))


@pytest.mark.cuda
def test_attn_smem_query_equals_the_formula_on_card(card):
    from repro_torch.analysis import workspace as ws
    for d in (32, 64, 100, 128, 256):
        for h in (8, 16, 100, 128):
            assert bcsr_attn.query("bcsr_attn_fused_threads", h) == \
                ws.attn_threads(h)
            for mb in (1, 33, 13823):
                assert bcsr_attn.query("bcsr_attn_fused_smem_bytes", d, h,
                                       mb) == ws.attn_smem_bytes(d, h, mb)


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,w", [(128, 128, 128), (64, 16, 16)])
def test_attn_max_bpr_boundary_on_card(card, d, h, w):
    """B5 launches at ``workspace.attn_max_bpr`` slots and is refused one
    slot past it (a one-row schedule: slot 0 holds the one stored block,
    the others the sentinel the kernel drops, so the operands stay one
    block); a refusal leaves no error behind for the next launch.  The
    result against softmax(q k^T) v: 1e-5 x max|ref| (3xTF32)."""
    from repro_torch.analysis import workspace as ws
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(1, n, d, generator=g, device=card)
               for n in (h, w, w))
    want = torch.softmax(q[0] @ k[0].T * d ** -0.5, dim=-1) @ v[0]

    def launch(slots):
        flat_idx = torch.ones(slots, dtype=torch.int32, device=card)
        flat_idx[0] = 0
        return bcsr_attn.bcsr_attn_fused(
            q, k, v, torch.ones(1, h, w, device=card), flat_idx,
            torch.zeros(slots, dtype=torch.int32, device=card),
            n_block_rows=1, n_block_cols=1, block=(h, w), scale=d ** -0.5)
    limit = ws.attn_max_bpr(d, h)
    out = launch(limit)
    torch.cuda.synchronize()
    assert (out[0] - want).abs().max() <= 1e-5 * want.abs().max()
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch(limit + 1)
    assert torch.equal(launch(limit), out)
