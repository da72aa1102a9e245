"""The port's ``sddmm`` and its gradients against the JAX package's on the
same numpy inputs.  f32 results agree within rtol = atol = 1e-5 (the
tolerance of ``tests/test_kernels.py:39``): both accumulate in float32, in
different orders.  The CUDA kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``)."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jops
from repro_torch.core import bcsr as tb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

from test_torch_ops import OPERANDS

TOL = dict(rtol=1e-5, atol=1e-5)


def _dense(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(make):
    ja, ta = make()
    j_arrays, j_meta = jops.prepare(ja, dtype=jnp.float32)
    t_arrays, t_meta = tops.prepare(ta, torch.float32, device="cpu")
    return j_arrays, j_meta, t_arrays, t_meta


@pytest.mark.parametrize("n", [8, 33])
@pytest.mark.parametrize("name,make", OPERANDS, ids=[n for n, _ in OPERANDS])
def test_sddmm_matches_jax_pallas_and_xla(name, make, n):
    """Every operand of the SpMM tests (the odd block shapes, padding
    entries and the transpose sentinel of ``_ragged``, near-empty rows),
    a ragged N, and X as a transposed view."""
    j_arrays, j_meta, t_arrays, t_meta = _pair(make)
    M, K = j_meta.shape
    x, y = _dense((M, n), 20), _dense((K, n), 21)
    got = tops.sddmm(t_arrays, t_meta, torch.from_numpy(x.T.copy()).T,
                     torch.from_numpy(y))
    assert got.shape == (t_meta.nnzb,) + t_meta.block
    for backend in ("pallas", "xla"):
        want = jops.sddmm(j_arrays, j_meta, jnp.asarray(x), jnp.asarray(y),
                          backend=backend, bn=128, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=backend, **TOL)
    pad = ~t_arrays.real_mask
    assert bool((got[pad] == 0).all())


def test_sddmm_backends_agree_and_keep_dtype():
    ta = tb.random_bcsr(2, (96, 160), (16, 16), 0.4)
    arrays, meta = tops.prepare(ta, torch.float32, device="cpu")
    x = torch.from_numpy(_dense((96, 24), 3))
    y = torch.from_numpy(_dense((160, 24), 4))
    want = tops.sddmm(arrays, meta, x, y, backend="xla")
    for backend in ("nnz_stream", "pallas", "auto", "dense"):
        torch.testing.assert_close(tops.sddmm(arrays, meta, x, y,
                                              backend=backend), want, **TOL)
    out = tops.sddmm(arrays, meta, x, y, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("name,make", [OPERANDS[1], OPERANDS[4]],
                         ids=[OPERANDS[1][0], OPERANDS[4][0]])
def test_sddmm_grads_match_jax(name, make, backend):
    """dX through spmm, dY through the transpose structure."""
    j_arrays, j_meta, t_arrays, t_meta = _pair(make)
    M, K = j_meta.shape
    n = 12
    x, y = _dense((M, n), 30), _dense((K, n), 31)
    cot = _dense((j_meta.nnzb,) + j_meta.block, 32)

    def f(x_, y_):
        vals = jops.sddmm(j_arrays, j_meta, x_, y_, backend=backend, bn=128,
                          interpret=True)
        return jnp.sum(vals * cot)
    want_x, want_y = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    vals = tops.sddmm(t_arrays, t_meta, tx, ty)
    assert vals.grad_fn is not None
    (vals * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(want_y), **TOL)


def test_spmm_grad_of_grad_matches_jax_xla():
    """A second derivative bounces between the two ops, as in JAX: h(v, b)
    = <df/dv, V1> + <df/db, V2> for f = <spmm(v, b), W>; dh/db runs the
    sddmm backward, dh/dv the derivative of dB = A^T W."""
    j_arrays, j_meta, t_arrays, t_meta = _pair(OPERANDS[4][1])   # ragged
    M, K = j_meta.shape
    n = 9
    b = _dense((K, n), 40)
    w_cot, v2 = _dense((M, n), 41), _dense((K, n), 42)
    v1 = _dense(tuple(j_arrays.vals.shape), 43)

    def f(v, b_):
        c = jops.spmm(j_arrays._replace(vals=v), j_meta, b_, backend="xla")
        return jnp.sum(c * w_cot)

    def h(v, b_):
        gv, gb = jax.grad(f, argnums=(0, 1))(v, b_)
        return jnp.sum(gv * v1) + jnp.sum(gb * v2)
    want_v, want_b = jax.grad(h, argnums=(0, 1))(j_arrays.vals,
                                                 jnp.asarray(b))

    tv = t_arrays.vals.clone().requires_grad_()
    tb_ = torch.from_numpy(b).requires_grad_()
    c = tops.spmm(t_arrays._replace(vals=tv), t_meta, tb_, backend="xla")
    fv = (c * torch.from_numpy(w_cot)).sum()
    gv, gb = torch.autograd.grad(fv, (tv, tb_), create_graph=True)
    hv = (gv * torch.from_numpy(v1)).sum() + (gb * torch.from_numpy(v2)).sum()
    got_v, got_b = torch.autograd.grad(hv, (tv, tb_))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **TOL)


def test_sddmm_dense_ref_equals_sampled_ref():
    ta = tb.random_bcsr(5, (64, 96), (16, 32), 0.5)
    arrays, meta = tops.prepare(ta, torch.float32, device="cpu")
    x = torch.from_numpy(_dense((64, 7), 60))
    y = torch.from_numpy(_dense((96, 7), 61))
    a = ref.bcsr_sddmm_ref(x, y, arrays.row_ids, arrays.col_ids, 16, 32)
    d = ref.bcsr_sddmm_dense_ref(x, y, arrays.row_ids, arrays.col_ids, 16, 32)
    torch.testing.assert_close(a, d, **TOL)
