"""The port's ops over G instances of one structure against the JAX
package's ``jax.vmap`` of its ops: ``ops.spmm`` with ``vals`` ``[G, nnzb,
h, w]`` and ``b`` ``[G, K, N]``, ``ops.sddmm`` with ``x`` ``[G, M, N]`` and
``y`` ``[G, K, N]``, forward and gradients, on the port's ``nnz_stream``,
``row_loop`` and ``xla`` backends (the first two take their kernels'
plain versions here) against ``jax.vmap`` of JAX's ``pallas`` (interpret
mode) and ``xla`` backends: f32 within 1e-5 (another summation order).
A batched call equals its G single calls stacked, bit for bit, on every
backend.  The composed attention path and B5's backward call each kernel
wrapper once per product, whatever G; the analyzer folds the instance
axis into grid x.  G = 3, 32 x 32 in 8 x 8 blocks, N = 16.  The kernels
themselves run only on the card (``tests/test_torch_kernels_cuda.py``)."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import bcsr as jb
from repro.kernels import ops as jops
from repro_torch.analysis import verify_launch as vl
from repro_torch.analysis import workspace as ws
from repro_torch.core import bcsr as tb
from repro_torch.kernels import autotune, bcsr_spmm
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as A

TOL = dict(rtol=1e-5, atol=1e-5)
G, SHAPE, BLOCK, N = 3, (32, 32), (8, 8), 16
PORT_BACKENDS = ("nnz_stream", "row_loop", "xla")


def _ragged():
    """An empty block-row (padded by prepare) and an empty block-col (a
    sentinel entry of the transpose structure)."""
    dense = np.random.default_rng(9).standard_normal(SHAPE).astype(
        np.float32)
    dense[np.abs(dense) < 0.8] = 0
    dense[8:16] = 0
    dense[:, 16:24] = 0
    return dense


CASES = {   # name -> (operand of either package, reorder)
    "ragged": (lambda m: m.from_dense(_ragged(), BLOCK), "identity"),
    "jaccard": (lambda m: m.random_bcsr(1, SHAPE, BLOCK, 0.4), "jaccard"),
}


@functools.lru_cache(maxsize=None)
def _prepared(case):
    make, reorder = CASES[case]
    j_arrays, j_meta = jops.prepare(make(jb), dtype=jnp.float32,
                                    reorder=reorder)
    t_arrays, t_meta = tops.prepare(make(tb), torch.float32,
                                    reorder=reorder, device="cpu")
    return j_arrays, j_meta, t_arrays, t_meta


def _inputs(case, seed=0):
    """Numpy operands of both ops: vals [G, nnzb, h, w], b [G, K, N], x
    [G, M, N], and the cotangents of spmm's and sddmm's outputs."""
    _, _, t_arrays, _ = _prepared(case)
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    M, K = SHAPE
    return {"vals": draw(G, *t_arrays.vals.shape), "b": draw(G, K, N),
            "x": draw(G, M, N), "g_out": draw(G, M, N),
            "g_vals": draw(G, *t_arrays.vals.shape)}


@functools.lru_cache(maxsize=None)
def _jax_reference(case, backend):
    """``jax.vmap`` of JAX's spmm and sddmm over the G instances, and
    ``jax.grad`` of each against a fixed cotangent, each under ``jax.jit``
    (op-by-op dispatch of the interpret-mode kernels takes seconds a
    call): numpy results."""
    j_arrays, j_meta, _, _ = _prepared(case)
    inp = _inputs(case)
    kw = dict(backend=backend, bn=N, interpret=True)

    def spmm(v, b):
        return jax.vmap(lambda vi, bi: jops.spmm(
            j_arrays._replace(vals=vi), j_meta, bi, **kw))(v, b)

    def sddmm(x, y):
        return jax.vmap(lambda xi, yi: jops.sddmm(
            j_arrays, j_meta, xi, yi, **kw))(x, y)
    v, b, x = (jnp.asarray(inp[k]) for k in ("vals", "b", "x"))
    g_out, g_vals = jnp.asarray(inp["g_out"]), jnp.asarray(inp["g_vals"])
    out = {"spmm": jax.jit(spmm)(v, b), "sddmm": jax.jit(sddmm)(x, b)}
    out["spmm_grads"] = jax.jit(jax.grad(
        lambda v, b: jnp.sum(spmm(v, b) * g_out), argnums=(0, 1)))(v, b)
    out["sddmm_grads"] = jax.jit(jax.grad(
        lambda x, y: jnp.sum(sddmm(x, y) * g_vals), argnums=(0, 1)))(x, b)
    return jax.tree_util.tree_map(np.asarray, out)


def _port(case, backend):
    """The port's batched spmm and sddmm, and their gradients against the
    same cotangents, as numpy arrays."""
    _, _, arrays, meta = _prepared(case)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(case).items()}
    v, b, x = (inp[k].clone().requires_grad_() for k in ("vals", "b", "x"))
    out = tops.spmm(arrays._replace(vals=v), meta, b, backend=backend)
    (out * inp["g_out"]).sum().backward()
    y = inp["b"].clone().requires_grad_()
    vals = tops.sddmm(arrays, meta, x, y, backend=backend)
    (vals * inp["g_vals"]).sum().backward()
    return {"spmm": out.detach().numpy(), "sddmm": vals.detach().numpy(),
            "spmm_grads": (v.grad.numpy(), b.grad.numpy()),
            "sddmm_grads": (x.grad.numpy(), y.grad.numpy())}


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_batched_ops_and_grads_match_jax_vmap(case, backend):
    got = _port(case, backend)
    assert got["spmm"].shape == (G, *SHAPE[:1], N)
    assert got["sddmm"].shape == (G, *_prepared(case)[2].vals.shape)
    for jax_backend in ("pallas", "xla"):
        want = _jax_reference(case, jax_backend)
        for key in ("spmm", "sddmm"):
            np.testing.assert_allclose(got[key], want[key], **TOL,
                                       err_msg=f"{key} vs {jax_backend}")
        for key in ("spmm_grads", "sddmm_grads"):
            for part, (g, w) in enumerate(zip(got[key], want[key])):
                np.testing.assert_allclose(
                    g, w, **TOL, err_msg=f"{key}[{part}] vs {jax_backend}")


@pytest.mark.parametrize("backend", PORT_BACKENDS + ("dense",))
@pytest.mark.parametrize("case", list(CASES))
def test_batched_call_equals_its_single_calls(case, backend):
    """Forward and gradients of a batched call equal the G single calls
    stacked, bit for bit."""
    _, _, arrays, meta = _prepared(case)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(case, seed=4).items()}

    def run(sl):
        v, b, x, y = (inp[k][sl].clone().requires_grad_()
                      for k in ("vals", "b", "x", "b"))
        out = tops.spmm(arrays._replace(vals=v), meta, b, backend=backend)
        (out * inp["g_out"][sl]).sum().backward()
        vals = tops.sddmm(arrays, meta, x, y, backend=backend)
        (vals * inp["g_vals"][sl]).sum().backward()
        return [out.detach(), vals.detach(), v.grad, b.grad, x.grad, y.grad]
    batched = run(slice(None))
    singles = [run(g) for g in range(G)]
    for i, got in enumerate(batched):
        assert torch.equal(got, torch.stack([s[i] for s in singles])), i


def test_batched_operands_must_all_carry_the_axis():
    """Every operand is batched, or none is: a wrapper, an op and a plain
    version each refuse a mix."""
    _, _, arrays, meta = _prepared("ragged")
    inp = {k: torch.from_numpy(v) for k, v in _inputs("ragged").items()}
    with pytest.raises(ValueError, match="leading instance axis"):
        tops.spmm(arrays._replace(vals=inp["vals"]), meta, inp["b"][0])
    with pytest.raises(ValueError, match="leading instance axis"):
        tops.spmm(arrays, meta, inp["b"])
    with pytest.raises(ValueError, match="leading instance axis"):
        tops.sddmm(arrays, meta, inp["x"], inp["b"][0])
    with pytest.raises(ValueError, match="leading instance axis"):
        bcsr_spmm.bcsr_sddmm(inp["x"], inp["b"][:2], arrays.row_ids,
                             arrays.col_ids, *BLOCK)


# ====================================================== one call per product
WRAPPERS = ("bcsr_spmm_nnz_stream", "bcsr_spmm_row_loop", "bcsr_sddmm",
            "bcsr_sddmm_row_loop")


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts every call of the four kernel wrappers (``ops`` calls them
    through the module), CPU calls included."""
    calls = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        real = getattr(bcsr_spmm, name)

        def counted(*args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(bcsr_spmm, name, counted)
    return calls


@pytest.fixture
def fresh_tuner():
    autotune.set_autotuner(autotune.Autotuner())
    yield
    autotune.set_autotuner(None)


def _attention(backend, B, H, L=64, d=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, d)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    out = A.block_sparse_attention(q, k, v, A.AttnSparsitySpec(
        mask=A.banded(24), block=BLOCK, backend=backend))
    return out, (q, k, v)


# the composed path's products: the forward's scores (SDDMM) and context
# (SpMM); the backward's d(probs) = g V^T (SDDMM), dV = P^T g (B1 over the
# transpose structure), dQ = dS K (the SpMM forward) and dK = dS^T Q (B1
# over the transpose structure).  B5's backward recomputes the forward.
ONCE = {
    "nnz_stream": {"fwd": {"bcsr_sddmm": 1, "bcsr_spmm_nnz_stream": 1},
                   "bwd": {"bcsr_sddmm": 1, "bcsr_spmm_nnz_stream": 3}},
    "row_loop": {"fwd": {"bcsr_sddmm_row_loop": 1, "bcsr_spmm_row_loop": 1},
                 "bwd": {"bcsr_sddmm_row_loop": 1, "bcsr_spmm_row_loop": 1,
                         "bcsr_spmm_nnz_stream": 2}},
}


def _nonzero(calls):
    return {k: v for k, v in calls.items() if v}


@pytest.mark.parametrize("B,H", [(1, 1), (2, 3)])
@pytest.mark.parametrize("backend", ["nnz_stream", "row_loop"])
def test_composed_path_calls_each_wrapper_once(wrapper_calls, backend, B, H):
    out, qkv = _attention(backend, B, H)
    assert _nonzero(wrapper_calls) == ONCE[backend]["fwd"]
    for name in WRAPPERS:
        wrapper_calls[name] = 0
    out.pow(2).sum().backward()
    assert _nonzero(wrapper_calls) == ONCE[backend]["bwd"]
    assert all(float(t.grad.abs().sum()) > 0 for t in qkv)


@pytest.mark.parametrize("B,H", [(1, 1), (2, 3)])
def test_fused_backward_calls_each_wrapper_once(wrapper_calls, fresh_tuner,
                                                B, H):
    """B5's forward calls no SpMM/SDDMM wrapper; its backward recomputes
    the composed path over all B * H instances, on the kernels ``auto``
    picks for the ops, and differentiates it: once per product."""
    out, qkv = _attention("fused", B, H)
    assert _nonzero(wrapper_calls) == {}
    meta = A.attention_mask_meta(A.banded(24), 64, BLOCK)
    picks = {op: tops.resolve_backend("auto", None, meta, 8, op=op,
                                      device="cpu")[0]
             for op in ("sddmm", "spmm")}
    out.pow(2).sum().backward()
    sddmm = {"nnz_stream": "bcsr_sddmm",
             "row_loop": "bcsr_sddmm_row_loop"}[picks["sddmm"]]
    spmm = {"nnz_stream": "bcsr_spmm_nnz_stream",
            "row_loop": "bcsr_spmm_row_loop"}[picks["spmm"]]
    want = {sddmm: 2, spmm: 2}
    want["bcsr_spmm_nnz_stream"] = want.get("bcsr_spmm_nnz_stream", 0) + 2
    assert _nonzero(wrapper_calls) == want
    assert all(float(t.grad.abs().sum()) > 0 for t in qkv)


def test_sharded_context_batches_its_scores(wrapper_calls):
    """With ``shards > 0`` the scores run once over all instances; the
    context product keeps one partitioned SpMM per instance and shard."""
    shards = 2
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 3, 8)).astype(
        np.float32)) for _ in range(3))
    A.block_sparse_attention(q, k, v, A.AttnSparsitySpec(
        mask=A.banded(24), block=BLOCK, backend="nnz_stream", shards=shards))
    assert wrapper_calls["bcsr_sddmm"] == 1
    assert wrapper_calls["bcsr_spmm_nnz_stream"] == 3 * shards


# ===================================================== the analyzer's grids
def test_grids_fold_the_instances_into_x():
    a = tb.random_bcsr_exact(0, (8192, 2048), (128, 128), 112)
    meta = tops.prepare_sparse_meta(a)
    assert vl.derive_grid(meta, "spmm", 2048, instances=16) == \
        (64 * 16, 32, 1)
    assert vl.derive_grid(meta, "sddmm", 2048, backend="nnz_stream",
                          instances=16) == (112 * 16, 2, 2)
    assert vl.derive_grid(meta, "sddmm", 2048, instances=16) == \
        (64 * meta.max_bpr * 16, 2, 2)
    # one instance past gridDim.x's 2**31 - 1 is refused on the host
    fits = ws.H100_GRID_X // meta.n_block_rows
    assert vl.verify_launch(meta, "nnz_stream", n=128, instances=fits) == []
    errs = vl.verify_launch(meta, "nnz_stream", n=128, instances=fits + 1)
    assert len(errs) == 1 and "gridDim.x" in errs[0] and \
        f"instances={fits + 1}" in errs[0]


def test_hook_receives_the_instances(monkeypatch):
    """``REPRO_VERIFY_LAUNCH=1``: a batched call's dispatch is checked
    once, over its G instances; the result is the unhooked one."""
    _, _, arrays, meta = _prepared("ragged")
    inp = {k: torch.from_numpy(v) for k, v in _inputs("ragged").items()}
    seen = []
    real = vl.assert_launch_ok
    monkeypatch.setattr(vl, "assert_launch_ok", lambda *a, **k: (
        seen.append(k["instances"]), real(*a, **k))[1])
    plain = tops.sddmm(arrays, meta, inp["x"], inp["b"])
    monkeypatch.setenv("REPRO_VERIFY_LAUNCH", "1")
    hooked = tops.sddmm(arrays, meta, inp["x"], inp["b"])
    tops.spmm(arrays, meta, inp["b"][0])
    assert seen == [G, 1]
    assert torch.equal(plain, hooked)
