"""The ``row_loop`` backend (SMaT's static schedule) against the JAX
package's: the schedule builders and the schedule fields ``prepare``
carries are exactly equal to JAX's; ``spmm``/``sddmm`` through it on the
CPU (the plain versions of kernels B3 and B4, which read the same schedule
arrays) and their gradients agree with JAX's ``row_loop`` in Pallas
interpret mode within 1e-5 (f32, another summation order), with and without
a row reorder -- the reorder branches of the autograd Functions included.
The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``)."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import bcsr as jb
from repro.core import sparse_linear as jsl
from repro.kernels import ops as jops
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import bcsr as tb
from repro_torch.core import sparse_linear as tsl
from repro_torch.kernels import bcsr_spmm, ref
from repro_torch.kernels import ops as tops

TOL = dict(rtol=1e-5, atol=1e-5)


def _ragged():
    dense = np.random.default_rng(9).standard_normal((50, 70)).astype(
        np.float32)
    dense[np.abs(dense) < 1.0] = 0
    dense[16:32] = 0                     # an empty block-row
    dense[:, 32:48] = 0                  # an empty block-col
    return dense


OPERANDS = [
    ("square8", lambda m: m.random_bcsr(0, (64, 64), (8, 8), 0.5)),
    ("odd16x32", lambda m: m.random_bcsr(1, (128, 256), (16, 32), 0.3)),
    ("odd32x16", lambda m: m.random_bcsr(2, (256, 128), (32, 16), 0.15)),
    ("ragged", lambda m: m.from_dense(_ragged(), (16, 16))),
    ("one_per_row", lambda m: m.random_bcsr_exact(3, (64, 64), (8, 8), 8)),
]
IDS = [n for n, _ in OPERANDS]


def _pair(make):
    return make(jb), make(tb)


# ----------------------------------------------------------------- schedules
@pytest.mark.parametrize("name,make", OPERANDS, ids=IDS)
def test_schedule_builders_equal_jax(name, make):
    ja, ta = _pair(make)
    jp, tp = ja.ensure_nonempty_rows(), ta.ensure_nonempty_rows()
    max_bpr = int(tp.blocks_per_row().max())
    for extra in (0, 2):          # the model's merged metas may pad max_bpr
        mb = max_bpr + extra
        want = jops._row_loop_schedule(jnp.asarray(jp.row_ids),
                                       jnp.asarray(jp.col_ids),
                                       jp.n_block_rows, mb)
        got = tops._row_loop_schedule(tp.row_ids, tp.col_ids,
                                      tp.n_block_rows, mb)
        for g, w in zip(got, want):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))
        want = jops._sddmm_row_loop_schedule(jnp.asarray(jp.row_ids),
                                             jnp.asarray(jp.col_ids),
                                             jp.n_block_rows, mb)
        got = tops._sddmm_row_loop_schedule(tp.row_ids, tp.col_ids,
                                            tp.n_block_rows, mb)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    want = jops.make_row_loop_schedule(ja)
    got = tops.make_row_loop_schedule(ta)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("reorder", ["identity", "jaccard", "rcm"])
@pytest.mark.parametrize("name,make", OPERANDS, ids=IDS)
def test_prepare_schedule_fields_equal_jax(name, make, reorder):
    """The port-only schedule fields are what the JAX package builds inside
    each row_loop call from the same arrays and meta."""
    ja, ta = _pair(make)
    j_arrays, j_meta = jops.prepare(ja, dtype=jnp.float32, reorder=reorder)
    t_arrays, t_meta = tops.prepare(ta, torch.float32, reorder=reorder,
                                    device="cpu")
    assert t_meta.max_bpr == j_meta.max_bpr > 0
    fi, fc, rl = jops._row_loop_schedule(j_arrays.row_ids, j_arrays.col_ids,
                                         j_meta.n_block_rows, j_meta.max_bpr)
    sfi, _ = jops._sddmm_row_loop_schedule(
        j_arrays.row_ids, j_arrays.col_ids, j_meta.n_block_rows,
        j_meta.max_bpr)
    for field, want in (("flat_idx", fi), ("flat_col", fc), ("row_len", rl),
                        ("sddmm_flat_idx", sfi)):
        got = getattr(t_arrays, field)
        assert got.dtype == torch.int32, field
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=field)


# -------------------------------------------------------------- forward ops
def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("reorder", ["identity", "jaccard", "rcm"])
@pytest.mark.parametrize("name,make", OPERANDS, ids=IDS)
def test_row_loop_spmm_and_sddmm_match_jax(name, make, reorder):
    ja, ta = _pair(make)
    j_arrays, j_meta = jops.prepare(ja, dtype=jnp.float32, reorder=reorder)
    t_arrays, t_meta = tops.prepare(ta, torch.float32, reorder=reorder,
                                    device="cpu")
    M, K = t_meta.shape
    n = 33
    b, x, y = _np(1, K, n), _np(2, M, n), _np(3, K, n)
    want = jops.spmm(j_arrays, j_meta, jnp.asarray(b), backend="row_loop",
                     bn=128, interpret=True)
    got = tops.spmm(t_arrays, t_meta, torch.from_numpy(b),
                    backend="row_loop")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jops.sddmm(j_arrays, j_meta, jnp.asarray(x), jnp.asarray(y),
                      backend="row_loop", bn=128, interpret=True)
    got = tops.sddmm(t_arrays, t_meta, torch.from_numpy(x),
                     torch.from_numpy(y), backend="row_loop")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name,make", OPERANDS, ids=IDS)
def test_plain_row_loop_versions_equal_the_streamed_ones(name, make):
    """B3's and B4's plain versions, reading the schedule (padding slots,
    sentinel and all), give the streamed plain versions' result."""
    _, ta = _pair(make)
    arrays, meta = tops.prepare(ta, torch.float32, device="cpu")
    h, w = meta.block
    b = torch.from_numpy(_np(4, meta.n_block_cols * w, 17))
    dc = torch.from_numpy(_np(5, meta.n_block_rows * h, 17))
    torch.testing.assert_close(
        ref.bcsr_spmm_row_loop_ref(arrays.vals, arrays.flat_idx,
                                   arrays.flat_col, arrays.row_len, b,
                                   meta.n_block_rows),
        ref.bcsr_spmm_ref(arrays.vals, arrays.row_ids, arrays.col_ids, b,
                          meta.n_block_rows), **TOL)
    torch.testing.assert_close(
        ref.bcsr_sddmm_row_loop_ref(dc, b, arrays.sddmm_flat_idx,
                                    arrays.flat_col, meta.n_block_rows,
                                    meta.nnzb, h, w),
        ref.bcsr_sddmm_ref(dc, b, arrays.row_ids, arrays.col_ids, h, w),
        **TOL)


def test_row_loop_wrappers_take_the_plain_versions_on_cpu(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU tensor must not build the kernel")
    monkeypatch.setattr(bcsr_spmm._build, "load", no_build)
    before = dict(bcsr_spmm.LAUNCHES)
    arrays, meta = tops.prepare(tb.random_bcsr(0, (64, 64), (8, 8), 0.5),
                                torch.float32, device="cpu")
    b = torch.from_numpy(_np(6, 64, 5))
    out = bcsr_spmm.bcsr_spmm_row_loop(arrays.vals, arrays.flat_idx,
                                       arrays.flat_col, arrays.row_len, b,
                                       meta.n_block_rows, bn=16)
    vals = bcsr_spmm.bcsr_sddmm_row_loop(b, b, arrays.sddmm_flat_idx,
                                         arrays.flat_col, meta.n_block_rows,
                                         meta.nnzb, 8, 8)
    assert out.shape == (64, 5) and vals.shape == (meta.nnzb, 8, 8)
    assert bcsr_spmm.LAUNCHES == before


def test_row_loop_wrappers_refuse_a_device_without_a_kernel():
    t = torch.zeros(8, 4, device="meta")
    idx = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bcsr_spmm.bcsr_spmm_row_loop(torch.zeros(1, 8, 8, device="meta"),
                                     idx, idx, idx, t, 1)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bcsr_spmm.bcsr_sddmm_row_loop(t, t, idx, idx, 1, 1, 8, 8)


def test_bn_is_a_tile_the_kernel_compiles():
    arrays, meta = tops.prepare(tb.random_bcsr(0, (64, 64), (8, 8), 0.5),
                                torch.float32, device="cpu")
    b = torch.from_numpy(_np(7, 64, 40))
    want = tops.spmm(arrays, meta, b, backend="xla")
    for backend in ("nnz_stream", "row_loop"):
        for bn in bcsr_spmm.SPMM_TILES:
            torch.testing.assert_close(
                tops.spmm(arrays, meta, b, backend=backend, bn=bn), want,
                **TOL)
        with pytest.raises(ValueError, match="not an N tile"):
            tops.spmm(arrays, meta, b, backend=backend, bn=128)
    x = torch.from_numpy(_np(8, 64, 40))
    tops.sddmm(arrays, meta, x, b, backend="row_loop", bn=32)
    with pytest.raises(ValueError, match="not an N tile"):
        tops.sddmm(arrays, meta, x, b, backend="row_loop", bn=16)
    with pytest.raises(ValueError, match="not an N tile"):
        tops.spmm(arrays, meta, b, backend="xla", bn=64)
    assert bcsr_spmm._tile(None, 40) == bcsr_spmm.tile_n(40) == 64
    with pytest.raises(ValueError, match="not a tile"):
        bcsr_spmm._tile(128, 40)


def test_row_loop_without_schedule_or_max_bpr_raises():
    arrays, meta = tops.prepare(tb.random_bcsr(0, (64, 64), (8, 8), 0.5),
                                torch.float32, device="cpu")
    b = torch.from_numpy(_np(9, 64, 4))
    with pytest.raises(ValueError, match="static schedule"):
        tops.spmm(arrays._replace(flat_idx=None), meta, b,
                  backend="row_loop")
    with pytest.raises(ValueError, match="max_bpr"):
        tops.spmm(arrays, dataclasses.replace(meta, max_bpr=0), b,
                  backend="row_loop")


# ----------------------------------------------------------------- gradients
@pytest.mark.parametrize("reorder", ["identity", "jaccard", "rcm"])
@pytest.mark.parametrize("name,make", OPERANDS, ids=IDS)
def test_row_loop_grads_match_jax(name, make, reorder):
    """dvals and dB of spmm, dX and dY of sddmm, against ``jax.grad`` of
    the JAX ``row_loop`` ops (interpret mode); B and X enter as the
    transposed views the model passes."""
    ja, ta = _pair(make)
    j_arrays, j_meta = jops.prepare(ja, dtype=jnp.float32, reorder=reorder)
    t_arrays, t_meta = tops.prepare(ta, torch.float32, reorder=reorder,
                                    device="cpu")
    M, K = t_meta.shape
    n = 11
    b, cot = _np(12, K, n), _np(13, M, n)
    x, y = _np(14, M, n), _np(15, K, n)
    h, w = t_meta.block
    cot_v = _np(16, t_meta.nnzb, h, w)

    def f(vals, b_):
        c = jops.spmm(j_arrays._replace(vals=vals), j_meta, b_,
                      backend="row_loop", bn=128, interpret=True)
        return jnp.sum(c * cot)

    def g(x_, y_):
        v = jops.sddmm(j_arrays, j_meta, x_, y_, backend="row_loop", bn=128,
                       interpret=True)
        return jnp.sum(v * cot_v)
    want_v, want_b = jax.grad(f, argnums=(0, 1))(j_arrays.vals,
                                                 jnp.asarray(b))
    want_x, want_y = jax.grad(g, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(y))

    vals = t_arrays.vals.clone().requires_grad_()
    bt = torch.from_numpy(b.T.copy()).requires_grad_()       # [N, K] leaf
    c = tops.spmm(t_arrays._replace(vals=vals), t_meta, bt.T,
                  backend="row_loop")
    (c * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(want_v), **TOL)
    np.testing.assert_allclose(bt.grad.T.numpy(), np.asarray(want_b), **TOL)
    assert bool((vals.grad[~t_arrays.real_mask] == 0).all())

    xt = torch.from_numpy(x.T.copy()).requires_grad_()
    yt = torch.from_numpy(y.copy()).requires_grad_()
    v = tops.sddmm(t_arrays, t_meta, xt.T, yt, backend="row_loop")
    (v * torch.from_numpy(cot_v)).sum().backward()
    np.testing.assert_allclose(xt.grad.T.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(want_y), **TOL)


# ------------------------------------------------------------ model buffers
def test_sparse_layer_schedule_buffers_convert_and_checkpoint(tmp_path):
    """A layer keeps the schedule fields as buffers; their rebuild from the
    JAX arrays (``ops.port_fields``, which ``convert.params_from_jax``
    runs) equals the port's own init, and a checkpoint round trip keeps
    them."""
    spec_t = tsl.SparsitySpec(density=0.3, block=(16, 16),
                              backend="row_loop", reorder="jaccard")
    spec_j = jsl.SparsitySpec(density=0.3, block=(16, 16), backend="xla",
                              reorder="jaccard")
    j_params, _ = jsl.init_sparse_linear(7919, 128, 256, spec_j,
                                         dtype=jnp.float32)
    t_params, t_meta = tsl.init_sparse_linear(7919, 128, 256, spec_t,
                                              torch.float32, device="cpu")
    layer = tsl.SparseLinear(t_params, t_meta, spec_t)
    assert set(tops.PORT_FIELDS) <= set(dict(layer.named_buffers()))
    rebuilt = tops.port_fields(
        np.asarray(j_params["row_ids"]), np.asarray(j_params["col_ids"]),
        np.asarray(j_params["t_row_ids"]), t_meta.n_block_rows,
        t_meta.n_block_cols, t_meta.max_bpr)
    for field, value in rebuilt.items():
        np.testing.assert_array_equal(getattr(layer, field).numpy(), value,
                                      err_msg=field)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"params": layer.state_dict()})
    blank = {k: torch.zeros_like(v) for k, v in layer.state_dict().items()}
    restored, _ = mgr.restore({"params": blank})
    for field in tops.PORT_FIELDS:
        assert torch.equal(restored["params"][field], getattr(layer, field))
