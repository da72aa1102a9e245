"""The port's CUDA kernels and the model path on the card, against their
plain PyTorch versions.  Every test here is marked ``cuda`` and skips on a
machine without a card; the file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: f32 rtol = atol = 1e-4 (the kernel's FMA order differs from the
plain einsum); bf16 out 1e-2, about one bf16 ulp of the plain f32 result.
The f32 training step: loss rtol 1e-5, every gradient max|diff| <= 1e-4 x
its max|grad| (f32 sums of a few hundred products in another order)."""
import dataclasses

import numpy as np
import pytest
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
    row-major and as transposed views."""
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
                got = bcsr_spmm.bcsr_sddmm_row_loop(
                    dc, x, arrays.sddmm_flat_idx, arrays.flat_col,
                    meta.n_block_rows, meta.nnzb, h, w)
                want = ref.bcsr_sddmm_row_loop_ref(
                    dc, x, arrays.sddmm_flat_idx, arrays.flat_col,
                    meta.n_block_rows, meta.nnzb, h, w,
                    out_dtype=torch.float32).to(dt)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
                assert bcsr_spmm.LAUNCHES["row_loop"] == \
                    before["row_loop"] + 1
                assert bcsr_spmm.LAUNCHES["sddmm_row_loop"] == \
                    before["sddmm_row_loop"] + 1


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
