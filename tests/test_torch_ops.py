"""The port's ``prepare``/``spmm`` and spmm's gradients against the JAX
package's on the same numpy inputs.  Host arrays and metas must be exactly
equal; f32 products and gradients agree within 1e-5 (the tolerance of
``tests/test_kernels.py:39``), since the two sum in different orders.  The
kernels themselves run only on the card
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


def _vec_ok(vec, n, w, esize, vals_ptr, b_ptr, sbk, sbn, kmajor):
    """The kernels' own check of a copy width (``spmm_tile::vec_ok``)."""
    if vec == esize:
        return True
    if vec < esize or vals_ptr % vec or b_ptr % vec or w * esize % vec:
        return False
    if kmajor:
        return sbn == 1 and sbk * esize % vec == 0 and n * esize % vec == 0
    return sbk == 1 and (n == 1 or sbn * esize % vec == 0)


# (N, h, w, dtype, vals_ptr, b_ptr, sbk, sbn) -> (bm, vec bytes, kmajor)
LAUNCH_CASES = [
    ((4, 128, 128, "bfloat16", 0, 0, 1, 2048), (16, 16, 0)),   # decode x^T
    ((2048, 128, 128, "bfloat16", 0, 0, 1, 2048), (128, 16, 0)),  # training
    ((8192, 128, 128, "bfloat16", 0, 0, 8192, 1), (128, 16, 1)),  # row-major
    ((128, 128, 128, "float32", 0, 0, 128, 1), (128, 16, 1)),  # attn bwd
    ((64, 64, 64, "float32", 0, 0, 64, 1), (16, 16, 1)),
    ((1024, 32, 16, "bfloat16", 0, 0, 1024, 1), (16, 16, 1)),  # short block
    ((33, 16, 16, "bfloat16", 0, 0, 33, 1), (16, 2, 1)),       # odd rows
    ((100, 16, 32, "bfloat16", 0, 0, 100, 1), (16, 8, 1)),
    ((100, 64, 32, "bfloat16", 0, 0, 100, 1), (16, 8, 1)),
    ((100, 16, 16, "float32", 0, 0, 100, 1), (16, 16, 1)),
    ((33, 16, 16, "float32", 0, 0, 33, 1), (16, 4, 1)),
    ((64, 128, 128, "bfloat16", 0, 2, 64, 1), (128, 2, 1)),    # base + 1
    ((64, 128, 128, "bfloat16", 0, 2, 1, 128), (128, 2, 0)),
    ((64, 128, 128, "float32", 0, 4, 1, 128), (128, 4, 0)),
    ((64, 128, 128, "bfloat16", 8, 0, 1, 128), (128, 8, 0)),   # vals + 8 B
    ((64, 128, 128, "bfloat16", 4, 0, 1, 128), (128, 4, 0)),
    ((1, 128, 128, "bfloat16", 0, 0, 1, 1), (16, 16, 0)),      # one token
    ((1, 128, 128, "bfloat16", 0, 0, 1, 5), (16, 16, 0)),
    ((64, 8, 4, "bfloat16", 0, 0, 1, 4), (16, 8, 0)),          # w = 4
    ((64, 8, 4, "float32", 0, 0, 1, 4), (16, 16, 0)),
    ((64, 16, 16, "bfloat16", 0, 0, 3, 7), (16, 2, 1)),        # both strided
    ((64, 16, 16, "float32", 0, 0, 2, 64), (16, 4, 1)),
]


@pytest.mark.parametrize("args,want", LAUNCH_CASES,
                         ids=[str(i) for i in range(len(LAUNCH_CASES))])
def test_spmm_launch_config_is_a_pure_function_of_the_operands(args, want):
    """The wrapper's BM, copy width and B staging from shape, strides and
    addresses alone: BM 16 at decode widths (N <= 16) and for h <= 64, else
    128; B k-major unless its k axis is contiguous; the widest copy whose
    every row start and chunk edge is aligned, which the kernels' own check
    (``spmm_tile::vec_ok``) also accepts."""
    n, h, w, dtype, vals_ptr, b_ptr, sbk, sbn = args
    dt = getattr(torch, dtype)
    got = bcsr_spmm.spmm_launch_config(n, h, w, dt, vals_ptr, b_ptr, sbk,
                                       sbn)
    assert got == want
    bm, vec, kmajor = got
    esize = torch.finfo(dt).bits // 8
    assert _vec_ok(vec, n, w, esize, vals_ptr, b_ptr, sbk, sbn, kmajor)
    assert not any(_vec_ok(v, n, w, esize, vals_ptr, b_ptr, sbk, sbn,
                           kmajor) for v in (16, 8, 4) if v > vec)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_launch_config_of_tensors(dtype):
    """On real tensors: the x^T view, row-major B, and B one element into
    its storage (the narrow copy; the wrapper never copies B)."""
    dt = getattr(torch, dtype)
    esize = torch.finfo(dt).bits // 8
    vals = torch.zeros((3, 128, 128), dtype=dt)
    flat = torch.zeros(1 + 512 * 64, dtype=dt)
    view = flat[:512 * 64].view(64, 512).T
    assert bcsr_spmm._launch_config(vals, view) == (128, 16, 0)
    row_major = flat[:512 * 64].view(512, 64)
    assert bcsr_spmm._launch_config(vals, row_major) == (128, 16, 1)
    shifted = flat[1:].view(512, 64)
    assert shifted.data_ptr() % 16 == esize
    assert bcsr_spmm._launch_config(vals, shifted) == (128, esize, 1)
    assert bcsr_spmm._launch_config(vals, shifted[:, :4]) == (16, esize, 1)


def _tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits): the low 13 bits of the f32
    mantissa masked off, after adding half of their range for ``rna``
    (round to nearest, ties away: the kernels' ``cvt.rna.tf32.f32``)."""
    bits = x.view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _3xtf32(vals, b, product, rounding):
    """The f32 kernels' 3xTF32 scheme on the CPU: each operand split into
    hi = tf32(x) and lo = tf32(x - hi); lo*hi + hi*lo + hi*hi, each product
    summed in f64 (the dropped lo*lo term is the scheme's own error)."""
    def split(x):
        hi = _tf32(x, rounding)
        return hi.double(), _tf32(x - hi, rounding).double()
    (ahi, alo), (bhi, blo) = split(vals), split(b)
    return (product(alo, bhi) + product(ahi, blo) + product(ahi, bhi))


@pytest.mark.parametrize("rounding", ["rna", "truncate"])
@pytest.mark.parametrize("L,block,window,d", [
    (256, (16, 16), 64, 32), (500, (32, 32), 128, 64),
    (640, (64, 64), 256, 128), (512, (128, 128), 256, 128)])
def test_3xtf32_split_meets_carve_out_2(rounding, L, block, window, d):
    """At small attention-backward shapes (the composed path's own
    probabilities over a banded mask; the context product P V and the
    dK/dV product P^T g) the 3xTF32 scheme stays within 1e-5 x max|C| of
    the exact product: carve-out 2's tolerance (ROADMAP C), met before the
    card is used.  One TF32 product alone does not meet it."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention as A
    mt = A.mask_tensors(A.banded(window), L, block, "cpu")
    a, meta = mt.arrays, mt.meta
    rng = np.random.default_rng(L)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (meta.n_block_rows * block[0], d)).astype(np.float32))
        for _ in range(4))
    scores = ref.bcsr_sddmm_ref(q, k, a.row_ids, a.col_ids, *block)
    probs = A.block_softmax(scores * d ** -0.5, mt.elem_mask, a.row_ids,
                            meta.n_block_rows, flat_idx=a.sddmm_flat_idx)
    t_vals = tops.transposed_vals(probs, a.t_perm)
    for vals, rows, cols, n_rows, rhs in (
            (probs, a.row_ids, a.col_ids, meta.n_block_rows, v),
            (t_vals, a.t_row_ids, a.t_col_ids, meta.n_block_cols, g)):
        def product(x, y, rows=rows, cols=cols, n_rows=n_rows):
            return ref.bcsr_spmm_ref(x, rows, cols, y, n_rows,
                                     out_dtype=torch.float64)
        exact = product(vals.double(), rhs.double())
        emulated = _3xtf32(vals, rhs, product, rounding).float().double()
        scale = exact.abs().max().item()
        assert (emulated - exact).abs().max().item() <= 1e-5 * scale
        one = product(_tf32(vals, rounding).double(),
                      _tf32(rhs, rounding).double())
        assert (one - exact).abs().max().item() > 1e-5 * scale


def _sddmm_vec_ok(vec, n, h, w, esize, dc_ptr, b_ptr, sdm, sdn, sbk, sbn,
                  ak, bk):
    """B2's own check of a copy width (``sddmm_tile::vec_ok``)."""
    if vec == esize:
        return True

    def one(ptr, rows, sr, sk, kmaj):
        if ptr % vec:
            return False
        if kmaj:
            return sr == 1 and rows * esize % vec == 0 and \
                (n == 1 or sk * esize % vec == 0)
        return sk == 1 and n * esize % vec == 0 and sr * esize % vec == 0
    return vec > esize and one(dc_ptr, h, sdm, sdn, ak) and \
        one(b_ptr, w, sbk, sbn, bk)


# (N, h, w, dtype, dc_ptr, b_ptr, sdm, sdn, sbk, sbn) -> (vec bytes, ak, bk)
SDDMM_LAUNCH_CASES = [
    ((2048, 128, 128, "bfloat16", 0, 0, 1, 2048, 1, 2048), (16, 1, 1)),  # FFN
    ((128, 128, 128, "float32", 0, 0, 128, 1, 128, 1), (16, 0, 0)),  # attn
    ((8192, 128, 128, "bfloat16", 0, 0, 1, 8192, 1, 8192), (16, 1, 1)),
    ((2048, 128, 128, "bfloat16", 0, 0, 2048, 1, 1, 2048), (16, 0, 1)),
    ((2048, 128, 128, "float32", 0, 0, 1, 2048, 2048, 1), (16, 1, 0)),
    ((33, 16, 16, "bfloat16", 0, 0, 33, 1, 33, 1), (2, 0, 0)),    # ragged N
    ((33, 16, 16, "float32", 0, 0, 33, 1, 33, 1), (4, 0, 0)),
    ((33, 16, 16, "float32", 0, 0, 1, 160, 1, 96), (16, 1, 1)),   # views
    ((100, 16, 32, "bfloat16", 0, 0, 100, 1, 100, 1), (8, 0, 0)),
    ((100, 24, 40, "bfloat16", 0, 0, 1, 96, 1, 200), (16, 1, 1)),  # ragged h
    ((64, 12, 16, "bfloat16", 0, 0, 1, 48, 1, 64), (8, 1, 1)),
    ((64, 6, 16, "bfloat16", 0, 0, 1, 24, 1, 64), (4, 1, 1)),
    ((64, 16, 20, "float32", 0, 0, 64, 1, 64, 1), (16, 0, 0)),    # ragged w
    ((64, 16, 20, "float32", 0, 0, 1, 64, 1, 100), (16, 1, 1)),
    ((64, 16, 10, "float32", 0, 0, 1, 64, 1, 50), (8, 1, 1)),
    ((64, 128, 128, "bfloat16", 2, 0, 64, 1, 64, 1), (2, 0, 0)),  # dc + 1
    ((64, 128, 128, "bfloat16", 0, 8, 64, 1, 64, 1), (8, 0, 0)),  # b + 8 B
    ((64, 128, 128, "float32", 4, 0, 1, 128, 1, 128), (4, 1, 1)),
    ((1, 128, 128, "bfloat16", 0, 0, 1, 1, 1, 1), (2, 0, 0)),     # N = 1
    ((1, 128, 128, "bfloat16", 0, 0, 1, 7, 1, 5), (16, 1, 1)),
    ((64, 16, 16, "bfloat16", 0, 0, 3, 7, 64, 1), (2, 1, 0)),     # strided
    ((64, 16, 16, "float32", 0, 0, 2, 64, 64, 1), (4, 1, 0)),
]


@pytest.mark.parametrize("args,want", SDDMM_LAUNCH_CASES,
                         ids=[str(i) for i in range(len(SDDMM_LAUNCH_CASES))])
def test_sddmm_launch_config_is_a_pure_function_of_the_operands(args, want):
    """B2's tile, copy width and operand staging from shape, strides and
    addresses alone: each operand staged k-major (its row axis) unless its
    N axis is contiguous, for both majorities of each; the widest copy that
    B2's own check (``sddmm_tile::vec_ok``) accepts, over ragged h, w and
    N and unaligned pointers; one 64 x 64 tile."""
    n, h, w, dtype, dc_ptr, b_ptr, sdm, sdn, sbk, sbn = args
    dt = getattr(torch, dtype)
    tile, vec, ak, bk = bcsr_spmm.sddmm_launch_config(
        n, h, w, dt, dc_ptr, b_ptr, sdm, sdn, sbk, sbn)
    assert (vec, ak, bk) == want and tile == (64, 64)
    esize = torch.finfo(dt).bits // 8
    ok = [v for v in (16, 8, 4, esize) if _sddmm_vec_ok(
        v, n, h, w, esize, dc_ptr, b_ptr, sdm, sdn, sbk, sbn, ak, bk)]
    assert vec == max(ok)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sddmm_launch_config_of_tensors(dtype):
    """On real tensors: the FFN backward's transposed views (both operands
    k-major), the attention backward's row-major Q and K, the two mixed,
    and operands one element into their storage (narrow copies; the
    wrapper never copies an operand)."""
    dt = getattr(torch, dtype)
    esize = torch.finfo(dt).bits // 8
    flat = torch.zeros(1 + 512 * 64, dtype=dt)
    row_major, view = flat[:512 * 64].view(512, 64), \
        flat[:512 * 64].view(64, 512).T

    def cfg(dc, b, h=128, w=128):
        return bcsr_spmm.sddmm_launch_config(
            dc.shape[1], h, w, dt, dc.data_ptr(), b.data_ptr(), *dc.stride(),
            *b.stride())[1:]
    assert cfg(view, view) == (16, 1, 1)
    assert cfg(row_major, row_major) == (16, 0, 0)
    assert cfg(view, row_major) == (16, 1, 0)
    assert cfg(row_major, view) == (16, 0, 1)
    shifted = flat[1:].view(512, 64)
    assert shifted.data_ptr() % 16 == esize
    assert cfg(shifted, row_major) == (esize, 0, 0)
    assert cfg(view, flat[1:].view(64, 512).T) == (esize, 1, 1)


# (operands, offset in elements) -> each a dC / B pair of the main paths:
# the FFN backward's transposed views of the cotangent and of x, and the
# attention backward's row-major Q and K
SDDMM_ARG_CASES = [(name, offset) for name in ("ffn_views", "attn_rows")
                   for offset in (0, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,offset", SDDMM_ARG_CASES,
                         ids=[f"{n}+{o}" for n, o in SDDMM_ARG_CASES])
def test_b2_and_b4_share_their_launch_arguments(name, offset, dtype):
    """Both SDDMM wrappers pass ``bcsr_spmm.sddmm_launch_args`` to their
    kernels: B4 stages its operands as B2 does, so it gets B2's ``(vec,
    ak, bk)`` from ``sddmm_launch_config`` and, on the same entries, B2's
    bits.  On CPU tensors: the shapes, the strides as given (no copy), the
    type codes, and the copy width falling to the element size one element
    off."""
    dt = getattr(torch, dtype)
    esize = torch.finfo(dt).bits // 8
    h = w = 128
    n = 2048 if name == "ffn_views" else 128
    flat = torch.zeros(offset + 3 * h * n, dtype=dt)
    if name == "ffn_views":         # dC^T [2h, n] and x^T [h, n] views
        dc = flat[offset:offset + 2 * h * n].view(n, 2 * h).T
        b = flat[offset + 2 * h * n:].view(n, h).T
    else:                            # row-major Q [2h, d] and K [h, d]
        dc = flat[offset:offset + 2 * h * n].view(2 * h, n)
        b = flat[offset + 2 * h * n:].view(h, n)
    args = bcsr_spmm.sddmm_launch_args(dc, b, h, w, torch.float32)
    tile, vec, ak, bk = bcsr_spmm.sddmm_launch_config(
        n, h, w, dt, dc.data_ptr(), b.data_ptr(), *dc.stride(), *b.stride())
    assert args == (h, w, n, *dc.stride(), *b.stride(), vec, ak, bk,
                    1 if dtype == "bfloat16" else 0, 0)
    assert (ak, bk) == ((1, 1) if name == "ffn_views" else (0, 0))
    assert vec == (esize if offset else 16)


@pytest.mark.parametrize("schedule", ["entries", "row_loop"])
@pytest.mark.parametrize("rounding", ["rna", "truncate"])
@pytest.mark.parametrize("L,block,window,d", [
    (256, (16, 16), 64, 32), (500, (32, 32), 128, 64),
    (512, (128, 128), 256, 128)])
def test_3xtf32_sddmm_meets_carve_out_2(schedule, rounding, L, block, window,
                                        d):
    """B2's 3xTF32 products (``schedule="entries"``) and B4's (the same
    products over the live slots of a ``row_loop`` schedule whose
    ``max_bpr`` is padded by 3, as a merged meta pads it: many padding
    slots) at small attention-backward shapes (the scores Q K^T over a
    banded mask) and at an FFN-backward shape (dvals, N = 2048 tokens)
    stay within 1e-5 x max|dvals| of the exact product: carve-out 2
    (ROADMAP C).  B4's also stay within it of the JAX package's
    ``bcsr_sddmm_row_loop`` in Pallas interpret mode.  One TF32 product
    alone does not meet it."""
    from repro.kernels import bcsr_spmm as jpk
    from repro_torch.kernels import ref
    from repro_torch.models import attention as A
    mt = A.mask_tensors(A.banded(window), L, block, "cpu")
    a, meta = mt.arrays, mt.meta
    rng = np.random.default_rng(L)
    q, k = (torch.from_numpy(rng.standard_normal(
        (meta.n_block_rows * block[0], d)).astype(np.float32))
        for _ in range(2))
    ffn = tb.random_bcsr_exact(2, (512, 256), (128, 128), 4)
    dc, x = (torch.from_numpy(rng.standard_normal((m, 2048)).astype(
        np.float32)) for m in (512, 256))
    for lhs, rhs, rows, cols, blk in (
            (q, k, a.row_ids, a.col_ids, block),
            (dc, x, torch.from_numpy(ffn.row_ids),
             torch.from_numpy(ffn.col_ids), (128, 128))):
        def entries(x, y, rows=rows, cols=cols, blk=blk):
            return ref.bcsr_sddmm_ref(x, y, rows, cols, *blk,
                                      out_dtype=torch.float64)
        product = entries
        if schedule == "row_loop":
            nbr, nnzb = lhs.shape[0] // blk[0], rows.shape[0]
            max_bpr = int(np.bincount(rows.numpy(), minlength=nbr).max()) + 3
            flat_idx, flat_col = tops._sddmm_row_loop_schedule(
                rows.numpy(), cols.numpy(), nbr, max_bpr)
            assert (flat_idx == nnzb).sum() >= 3 * nbr

            def product(x, y, fi=torch.from_numpy(flat_idx),
                        fc=torch.from_numpy(flat_col), nbr=nbr, nnzb=nnzb,
                        blk=blk):
                return ref.bcsr_sddmm_row_loop_ref(
                    x, y, fi, fc, nbr, nnzb, *blk, out_dtype=torch.float64)
        exact = entries(lhs.double(), rhs.double())
        emulated = _3xtf32(lhs, rhs, product, rounding).float().double()
        scale = exact.abs().max().item()
        assert (emulated - exact).abs().max().item() <= 1e-5 * scale
        if schedule == "row_loop":
            tpu = torch.from_numpy(np.array(jpk.bcsr_sddmm_row_loop(
                jnp.asarray(lhs.numpy()), jnp.asarray(rhs.numpy()),
                jnp.asarray(flat_idx), jnp.asarray(flat_col), nbr, nnzb,
                *blk, interpret=True))).double()
            assert (emulated - tpu).abs().max().item() <= \
                1e-5 * tpu.abs().max().item()
        one = product(_tf32(lhs, rounding).double(),
                      _tf32(rhs, rounding).double())
        assert (one - exact).abs().max().item() > 1e-5 * scale


def _b5_split(x):
    """B5's split: hi rounded to TF32 to nearest (an integer add and mask),
    lo = x - hi, which the tensor cores read truncated to TF32."""
    hi = _tf32(x, "rna")
    return hi.double(), _tf32(x - hi, "truncate").double()


@pytest.mark.parametrize("mask,L,block,d", [
    ("banded", 256, (16, 16), 32), ("local_global", 500, (32, 32), 64),
    ("banded", 512, (128, 128), 128)])
def test_3xtf32_b5_meets_carve_out_2(mask, L, block, d):
    """B5's two products in its order, emulated on the CPU: S = Q K^T and
    z V as lo*hi + hi*lo + hi*hi of B5's split, z = exp(S - max) over the
    row's slots, the context (z V) / sum(z); within 1e-5 x max|context| of
    the exact (f64) two-pass attention -- carve-out 2 -- where one TF32
    product alone is not."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention as A
    spec = {"banded": A.banded(L // 4),
            "local_global": A.local_global(64, 20)}[mask]
    mt = A.mask_tensors(spec, L, block, "cpu")
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, L, d)).astype(
        np.float32)) for _ in range(3))
    kw = dict(n_block_rows=mt.meta.n_block_rows,
              n_block_cols=mt.meta.n_block_cols, block=block,
              scale=d ** -0.5)
    args = (mt.emask, mt.arrays.sddmm_flat_idx, mt.arrays.flat_col)

    def attention(product):
        """ref.bcsr_attn_fused_ref's two passes with its einsums replaced
        by ``product(x, y, spec)``, in f64."""
        import torch.nn.functional as F
        G, h, w = 1, *block
        nbr, nbc = kw["n_block_rows"], kw["n_block_cols"]
        max_bpr = args[1].shape[0] // nbr
        qb = F.pad(q, (0, 0, 0, nbr * h - L)).reshape(G, nbr, h, d)
        kb = F.pad(k, (0, 0, 0, nbc * w - L)).reshape(G, nbc, w, d)
        vb = F.pad(v, (0, 0, 0, nbc * w - L)).reshape(G, nbc, w, d)
        col = args[2].long().reshape(nbr, max_bpr)
        em = (F.pad(args[0], (0, 0, 0, 0, 0, 1))[args[1].long()] != 0
              ).reshape(nbr, max_bpr, h, w)
        s = product(qb, kb[:, col], "gihd,gitwd->githw") * kw["scale"]
        logits = torch.where(em, s, -2.0e38)
        m = logits.amax(dim=(2, 4)).clamp_min(-1e30)
        z = torch.where(em, torch.exp(logits - m[:, :, None, :, None]), 0.0)
        den = z.sum(dim=4).sum(dim=2).clamp_min(1e-30)
        ctx = product(z.float(), vb[:, col], "githw,gitwe->gihe")
        return (ctx / den[..., None]).reshape(G, nbr * h, d)[:, :L]

    def exact(x, y, eq):
        return torch.einsum(eq, x.double(), y.double())

    def three(x, y, eq):
        (xh, xl), (yh, yl) = _b5_split(x), _b5_split(y)
        return (torch.einsum(eq, xl, yh) + torch.einsum(eq, xh, yl) +
                torch.einsum(eq, xh, yh))

    def one(x, y, eq):
        return torch.einsum(eq, _tf32(x, "rna").double(),
                            _tf32(y, "rna").double())
    want = attention(exact)
    assert torch.allclose(want.float(), ref.bcsr_attn_fused_ref(
        q, k, v, *args, **kw), rtol=1e-5, atol=1e-5)
    scale = want.abs().max().item()
    assert (attention(three) - want).abs().max().item() <= 1e-5 * scale
    assert (attention(one) - want).abs().max().item() > 1e-5 * scale


def test_device_rowptr_matches_host():
    ta = tb.random_bcsr(4, (160, 96), (16, 16), 0.08).ensure_nonempty_rows()
    got = bcsr_spmm.rowptr_from_rows(torch.from_numpy(ta.row_ids),
                                     ta.n_block_rows)
    np.testing.assert_array_equal(got.numpy(), ta.rowptr)

