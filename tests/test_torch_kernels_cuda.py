"""The port's CUDA kernel and the model path on the card, against their
plain PyTorch versions.  Every test here is marked ``cuda`` and skips on a
machine without a card; the file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: f32 rtol = atol = 1e-4 (the kernel's FMA order differs from the
plain einsum); bf16 out 1e-2, about one bf16 ulp of the plain f32 result."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import bcsr as tb
from repro_torch.kernels import bcsr_spmm, ref
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as T

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
