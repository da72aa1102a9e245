"""The port's ``prepare``/``spmm`` and spmm's gradients against the JAX
package's on the same numpy inputs.  Host arrays and metas must be exactly
equal; f32 products and gradients agree within 1e-5 (the tolerance of
``tests/test_kernels.py:39``), since the two sum in different orders.  The
kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcsr as jb
from repro.kernels import ops as jops
from repro_torch.core import bcsr as tb
from repro_torch.kernels import autotune, bcsr_spmm
from repro_torch.kernels import ops as tops

SHAPES = [                       # tests/test_kernels.py:19
    ((64, 64), (8, 8), 0.5),
    ((128, 256), (16, 32), 0.3),
    ((256, 128), (32, 16), 0.15),
    ((96, 160), (16, 16), 0.4),
]


def _ragged():
    """Unaligned M, K; an empty block-row (padded by prepare) and an empty
    block-col (a sentinel entry in the transpose structure)."""
    dense = np.random.default_rng(9).standard_normal((50, 70)).astype(
        np.float32)
    dense[np.abs(dense) < 1.0] = 0
    dense[16:32] = 0
    dense[:, 32:48] = 0
    return dense


def _operands():
    out = [(f"{s}{b}", lambda s=s, b=b, d=d: (jb.random_bcsr(0, s, b, d),
                                              tb.random_bcsr(0, s, b, d)))
           for s, b, d in SHAPES]
    out.append(("ragged", lambda: (jb.from_dense(_ragged(), (16, 16)),
                                   tb.from_dense(_ragged(), (16, 16)))))
    out.append(("sparse_rows", lambda: (
        jb.random_bcsr(4, (160, 96), (16, 16), 0.08),
        tb.random_bcsr(4, (160, 96), (16, 16), 0.08))))
    return out


OPERANDS = _operands()


@pytest.mark.parametrize("name,make", OPERANDS, ids=[n for n, _ in OPERANDS])
def test_prepare_arrays_and_meta_equal(name, make):
    ja, ta = make()
    j_arrays, j_meta = jops.prepare(ja, dtype=jnp.float32)
    t_arrays, t_meta = tops.prepare(ta, torch.float32, device="cpu")
    for field in jops.SparseArrays._fields:
        want = np.asarray(getattr(j_arrays, field))
        got = getattr(t_arrays, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert dataclasses.asdict(t_meta) == dataclasses.asdict(j_meta)
    assert tops.prepare(ta, meta_only=True) == t_meta
    # the port's own rowptr is the padded structure's
    padded = ta.ensure_nonempty_rows()
    np.testing.assert_array_equal(t_arrays.rowptr.numpy(), padded.rowptr)


def _b(k, n, seed=1):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


@pytest.mark.parametrize("shape,block,density", SHAPES)
@pytest.mark.parametrize("n", [8, 64])
def test_spmm_matches_jax_pallas_and_xla(shape, block, density, n):
    ja = jb.random_bcsr(0, shape, block, density)
    ta = tb.random_bcsr(0, shape, block, density)
    b = _b(shape[1], n)
    j_arrays, j_meta = jops.prepare(ja, dtype=jnp.float32)
    t_arrays, t_meta = tops.prepare(ta, torch.float32, device="cpu")
    got = tops.spmm(t_arrays, t_meta, torch.from_numpy(b)).numpy()
    for backend in ("pallas", "xla"):
        want = jops.spmm(j_arrays, j_meta, jnp.asarray(b), backend=backend,
                         bn=min(64, n), interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=backend)


@pytest.mark.parametrize("n", [8, 33, 64])
def test_spmm_unaligned_shapes_match_jax(n):
    dense = _ragged()
    j_arrays, j_meta = jops.prepare(jb.from_dense(dense, (16, 16)),
                                    dtype=jnp.float32)
    t_arrays, t_meta = tops.prepare(tb.from_dense(dense, (16, 16)),
                                    torch.float32, device="cpu")
    b = _b(70, n, seed=10)
    got = tops.spmm(t_arrays, t_meta, torch.from_numpy(b)).numpy()
    want = jops.spmm(j_arrays, j_meta, jnp.asarray(b), backend="pallas",
                     bn=128, interpret=True)
    assert got.shape == (50, n)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, dense @ b, rtol=1e-4, atol=1e-4)


def test_spmm_bf16_matches_jax():
    """bf16 operands, f32 accumulation, bf16 out: within 1 bf16 ulp of the
    JAX kernel's result (rtol = atol = 1e-2)."""
    ja = jb.random_bcsr(0, (128, 128), (16, 16), 0.3)
    ta = tb.random_bcsr(0, (128, 128), (16, 16), 0.3)
    b = _b(128, 64, seed=3)
    j_arrays, j_meta = jops.prepare(ja, dtype=jnp.bfloat16)
    t_arrays, t_meta = tops.prepare(ta, torch.bfloat16, device="cpu")
    got = tops.spmm(t_arrays, t_meta, torch.from_numpy(b).bfloat16())
    want = jops.spmm(j_arrays, j_meta, jnp.asarray(b).astype(jnp.bfloat16),
                     backend="pallas", bn=64, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_backends_and_strided_b_agree():
    """nnz_stream (plain version on the CPU), its alias, auto, xla and dense
    give one result, and a transposed view of B (as the model passes x^T)
    gives the same as a contiguous B."""
    ta = tb.random_bcsr(2, (96, 160), (16, 16), 0.4)
    arrays, meta = tops.prepare(ta, torch.float32, device="cpu")
    x = torch.from_numpy(_b(16, 160, seed=5))          # [T, K]
    want = tops.spmm(arrays, meta, x.T.contiguous(), backend="xla")
    for backend in ("nnz_stream", "pallas", "auto", "dense"):
        got = tops.spmm(arrays, meta, x.T, backend=backend)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    out = tops.spmm(arrays, meta, x.T, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16


def test_resolve_backend_rules():
    """Aliases resolve, ``row_loop`` resolves for a meta with ``max_bpr``
    (and raises without one), an explicit ``bn`` must be a tile the
    backend's kernel compiles, and unknown names raise."""
    _, meta = tops.prepare(tb.random_bcsr(2, (96, 160), (16, 16), 0.4),
                           torch.float32, device="cpu")

    def resolve(backend, bn=None, meta=meta):
        return tops.resolve_backend(backend, bn, meta, 64, device="cpu")
    assert resolve("pallas") == ("nnz_stream", None)
    assert resolve("nnz_stream", 32) == ("nnz_stream", 32)
    assert resolve("xla") == ("xla", None)
    assert resolve("dense", 0) == ("dense", None)
    assert resolve("row_loop") == ("row_loop", None)
    assert resolve("row_loop", 8) == ("row_loop", 8)
    with pytest.raises(ValueError, match="max_bpr"):
        resolve("row_loop", meta=dataclasses.replace(meta, max_bpr=0))
    with pytest.raises(ValueError, match="not an N tile"):
        resolve("nnz_stream", 512)
    with pytest.raises(ValueError, match="not an N tile"):
        resolve("xla", 64)
    with pytest.raises(ValueError, match="unknown backend"):
        resolve("cusparse")


def test_spmm_refuses_autograd():
    """spmm no longer refuses autograd: under grad it returns a tensor with
    a ``grad_fn``, and ``torch.no_grad()`` (and inference mode, which
    serving runs under) gives the same values with none."""
    arrays, meta = tops.prepare(tb.random_bcsr_exact(0, (64, 64), (8, 8), 16),
                                torch.float32, device="cpu")
    b = torch.from_numpy(_b(64, 4, seed=2)).requires_grad_()
    out = tops.spmm(arrays, meta, b)
    assert out.grad_fn is not None
    with torch.no_grad():
        plain = tops.spmm(arrays, meta, b)
    with torch.inference_mode():
        inferred = tops.spmm(arrays, meta, b)
    assert plain.grad_fn is None and inferred.grad_fn is None
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
    torch.testing.assert_close(inferred, plain, rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("name,make", OPERANDS, ids=[n for n, _ in OPERANDS])
def test_spmm_grads_match_jax(name, make, backend):
    """dvals (through sddmm) and dB (through the transpose structure)
    against ``jax.grad`` of the JAX ``spmm``; B enters as the transposed
    view the model passes, and the padding entries' dvals are exactly 0."""
    ja, ta = make()
    j_arrays, j_meta = jops.prepare(ja, dtype=jnp.float32)
    t_arrays, t_meta = tops.prepare(ta, torch.float32, device="cpu")
    M, K = j_meta.shape
    n = 11
    b, cot = _b(K, n, seed=12), _b(M, n, seed=13)

    def f(vals, b_):
        c = jops.spmm(j_arrays._replace(vals=vals), j_meta, b_,
                      backend=backend, bn=128, interpret=True)
        return jnp.sum(c * cot)
    want_v, want_b = jax.grad(f, argnums=(0, 1))(j_arrays.vals,
                                                 jnp.asarray(b))
    vals = t_arrays.vals.clone().requires_grad_()
    bt = torch.from_numpy(b.T.copy()).requires_grad_()    # [N, K] leaf
    c = tops.spmm(t_arrays._replace(vals=vals), t_meta, bt.T)
    (c * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(want_v),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bt.grad.T.numpy(), np.asarray(want_b),
                               rtol=1e-5, atol=1e-5)
    pad = ~t_arrays.real_mask
    assert bool((vals.grad[pad] == 0).all())


@pytest.mark.parametrize("name,make", OPERANDS, ids=[n for n, _ in OPERANDS])
def test_t_rowptr_is_the_transpose_structures_rowptr(name, make):
    ja, ta = make()
    j_arrays, j_meta = jops.prepare(ja, dtype=jnp.float32)
    t_arrays, _ = tops.prepare(ta, torch.float32, device="cpu")
    want = jb.rowptr_from_rows(np.asarray(j_arrays.t_row_ids),
                               j_meta.n_block_cols)
    got = t_arrays.t_rowptr.numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_resolve_backend_takes_the_op():
    """``auto`` asks the autotuner for the op's own family on the device
    given; each op checks ``bn`` against its own kernels' tiles."""
    _, meta = tops.prepare(tb.random_bcsr(2, (96, 160), (16, 16), 0.4),
                           torch.float32, device="cpu")
    tuner = autotune.Autotuner()
    autotune.set_autotuner(tuner)
    try:
        for op in ("spmm", "sddmm"):
            choice = tuner.pick(meta, 64, op=op, device="cpu")
            assert autotune.get_variant(choice.variant).op == op
            assert tops.resolve_backend("auto", None, meta, 64, op=op,
                                        device="cpu") == \
                (choice.backend, choice.bn or None)
    finally:
        autotune.set_autotuner(None)
    assert tops.resolve_backend("xla", None, meta, 64, op="sddmm",
                                device="cpu") == ("xla", None)
    assert tops.resolve_backend("nnz_stream", 32, meta, 64, op="sddmm",
                                device="cpu") == ("nnz_stream", 32)
    with pytest.raises(ValueError, match="not an N tile"):
        tops.resolve_backend("nnz_stream", 64, meta, 64, op="sddmm",
                             device="cpu")
    with pytest.raises(ValueError, match="unknown op"):
        tops.resolve_backend("xla", None, meta, 64, op="attn", device="cpu")


def test_materialize_dense_matches_host():
    ta = tb.random_bcsr(6, (96, 160), (16, 16), 0.4)
    arrays, meta = tops.prepare(ta, torch.float32, device="cpu")
    np.testing.assert_array_equal(
        tops.materialize_dense(arrays, meta).numpy()[:96, :160],
        ta.to_dense())


@pytest.mark.parametrize("n", [1, 8, 9, 33, 64, 65, 1024])
def test_tile_n_covers_n(n):
    bn = bcsr_spmm.tile_n(n)
    assert bn in (8, 16, 32, 64)
    assert bn >= n or bn == 64


def test_device_rowptr_matches_host():
    ta = tb.random_bcsr(4, (160, 96), (16, 16), 0.08).ensure_nonempty_rows()
    got = bcsr_spmm.rowptr_from_rows(torch.from_numpy(ta.row_ids),
                                     ta.n_block_rows)
    np.testing.assert_array_equal(got.numpy(), ta.rowptr)

