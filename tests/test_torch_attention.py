"""The port's block-sparse attention against the JAX package's, at the sizes
of ``tests/test_attn_fused.py`` (L 64 and 61, block (8, 8), d 8, B = H = 2:
JAX's interpret-mode kernel is slow).

Tolerances: host data (mask BCSR, metas, element masks, schedules, page
tables, the paged-decode decision) exactly equal; f32 on the CPU, 1e-5 for
B5's plain version against JAX's interpret-mode kernel and for
``block_sparse_attention`` (fused and composed) and its gradients against
JAX (``test_attn_fused.py``'s tolerances); 1e-4 for the model's logits and
loss (the ROADMAP's)."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import dataclasses
import doctest
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jax_get_config
from repro.kernels import autotune as jat
from repro.kernels import bcsr_attn as jbk
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.kernels import autotune, bcsr_attn, ref
from repro_torch.models import attention as A
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T

ARCH = "smat-attn-1.3b"
BLOCK = (8, 8)
MASKS = {
    "banded": (JA.banded(24), A.banded(24)),
    "local_global": (JA.local_global(16, 8), A.local_global(16, 8)),
    "blockwise_causal": (JA.blockwise_causal(), A.blockwise_causal()),
    "banded_window_cap": (dataclasses.replace(JA.banded(24), window_cap=12),
                          dataclasses.replace(A.banded(24), window_cap=12)),
}


@pytest.fixture(autouse=True)
def _fresh_tuners():
    jat.set_autotuner(jat.Autotuner())
    autotune.set_autotuner(autotune.Autotuner())
    yield
    jat.set_autotuner(None)
    autotune.set_autotuner(None)


def _qkv(L, d=8, B=2, H=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, L, H, d)).astype(np.float32)
                 for _ in range(3))


def _t(*arrays, grad=False):
    return tuple(torch.from_numpy(a.copy()).requires_grad_(grad)
                 for a in arrays)


# ============================================================ host pipeline
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("L", [64, 61])
def test_mask_pipeline_equals_jax(mask, L):
    """attention_mask_bcsr, _meta, _arrays, _fused_inputs and
    decode_page_table exactly equal to JAX's."""
    jm, tm = MASKS[mask]
    ja, ta = JA.attention_mask_bcsr(jm, L, BLOCK), \
        A.attention_mask_bcsr(tm, L, BLOCK)
    for f in ("vals", "row_ids", "col_ids", "rowptr"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f), f)
    assert (ta.shape, ta.block) == (ja.shape, ja.block)
    jmeta, tmeta = JA.attention_mask_meta(jm, L, BLOCK), \
        A.attention_mask_meta(tm, L, BLOCK)
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)
    jarr, _ = JA.attention_mask_arrays(jm, L, BLOCK)
    tarr, _ = A.attention_mask_arrays(tm, L, BLOCK)
    for f in jarr._fields:
        np.testing.assert_array_equal(getattr(tarr, f), getattr(jarr, f), f)
    for got, want in zip(A._fused_inputs(tm, L, BLOCK)[:3],
                         JA._fused_inputs(jm, L, BLOCK)[:3]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(A.decode_page_table(tm, L, BLOCK)[:2],
                         JA.decode_page_table(jm, L, BLOCK)[:2]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mask", list(MASKS))
def test_prepare_schedule_equals_fused_inputs(mask):
    """The device tensors come from ops.prepare; its SDDMM schedule and
    column list are JAX's fused schedule, and emask its element mask."""
    jm, tm = MASKS[mask]
    emask, flat_idx, flat_col, meta = JA._fused_inputs(jm, 61, BLOCK)
    mt = A.mask_tensors(tm, 61, BLOCK, "cpu")
    np.testing.assert_array_equal(mt.arrays.sddmm_flat_idx.numpy(), flat_idx)
    np.testing.assert_array_equal(mt.arrays.flat_col.numpy(), flat_col)
    np.testing.assert_array_equal(mt.emask.numpy(), emask)
    np.testing.assert_array_equal(mt.arrays.vals.numpy(), emask)
    assert mt.elem_mask.dtype == torch.bool
    assert dataclasses.asdict(mt.meta) == dataclasses.asdict(meta)
    assert A.mask_tensors(tm, 61, list(BLOCK), "cpu") is mt    # cached


@pytest.mark.parametrize("mode", ["auto", "force", "off"])
@pytest.mark.parametrize("cache_len", [64, 48, 40, 16])
@pytest.mark.parametrize("window", [None, 16])
def test_decode_pages_decision_equals_jax(mode, cache_len, window):
    jcfg, tcfg = jax_get_config(ARCH + ":smoke"), get_config(ARCH + ":smoke")
    jcfg = dataclasses.replace(jcfg, attn_sparsity=dataclasses.replace(
        jcfg.attn_sparsity, paged_decode=mode))
    tcfg = dataclasses.replace(tcfg, attn_sparsity=dataclasses.replace(
        tcfg.attn_sparsity, paged_decode=mode))
    want = JL._decode_pages(jcfg, window, cache_len)
    got = TL._decode_pages(tcfg, window, cache_len)
    assert (got is None) == (want is None)
    if want is not None:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_decode_bias_equals_jax():
    for jm, tm in MASKS.values():
        q, k = np.array([37]), np.arange(-3, 64)
        want = np.asarray(JA.decode_mask_bias(jm, jnp.asarray(q),
                                              jnp.asarray(k)))
        got = A.decode_mask_bias(tm, torch.from_numpy(q),
                                 torch.from_numpy(k)).numpy()
        np.testing.assert_array_equal(got, want)


# ================================================================ softmax
@pytest.mark.parametrize("mask", ["banded", "local_global"])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_block_softmax_equals_jax(mask, cap):
    """1e-5; the port reduces through the slot schedule ``prepare``
    builds."""
    jm, tm = MASKS[mask]
    jarr, meta = JA.attention_mask_arrays(jm, 61, BLOCK)
    elem = (jarr.vals > 0.5) & jarr.real_mask[:, None, None]
    scores = np.random.default_rng(1).standard_normal(
        jarr.vals.shape).astype(np.float32) * 3
    want = np.asarray(JA.block_softmax(jnp.asarray(scores), elem,
                                       jarr.row_ids, meta.n_block_rows,
                                       cap=cap))
    mt = A.mask_tensors(tm, 61, BLOCK, "cpu")
    got = A.block_softmax(torch.from_numpy(scores), mt.elem_mask,
                          mt.arrays.row_ids, meta.n_block_rows, cap=cap,
                          flat_idx=mt.arrays.sddmm_flat_idx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[~elem] == 0).all()


# =================================================================== B5
@pytest.mark.parametrize("mask", ["banded", "local_global",
                                  "blockwise_causal"])
@pytest.mark.parametrize("L", [64, 61])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_b5_plain_equals_jax_interpret_kernel(mask, L, cap):
    jm, tm = MASKS[mask]
    emask, flat_idx, flat_col, meta = JA._fused_inputs(jm, L, BLOCK)
    rng = np.random.default_rng(L)
    q, k, v = (rng.standard_normal((4, L, 8)).astype(np.float32)
               for _ in range(3))
    kw = dict(n_block_rows=meta.n_block_rows, n_block_cols=meta.n_block_cols,
              block=BLOCK, scale=8 ** -0.5, cap=cap)
    want = np.asarray(jbk.bcsr_attn_fused(
        *map(jnp.asarray, (q, k, v)), emask, flat_idx, flat_col,
        interpret=True, **kw))
    mt = A.mask_tensors(tm, L, BLOCK, "cpu")
    args = (*_t(q, k, v), mt.emask, mt.arrays.sddmm_flat_idx,
            mt.arrays.flat_col)
    got = ref.bcsr_attn_fused_ref(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = dict(bcsr_attn.LAUNCHES)
    assert torch.equal(bcsr_attn.bcsr_attn_fused(*args, **kw), got)
    assert bcsr_attn.LAUNCHES == before


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("L", [64, 61])
def test_pack_emask_round_trips_on_jax_masks(mask, L):
    """B5's bitmask of the JAX package's element masks: one bit an element
    (int32 words, [nnzb + 1, h, ceil(w / 32)]), unpacked exactly back to
    the mask, the sentinel block all zeros, and the port's cached
    ``mask_tensors(...).ebits`` the same words."""
    jm, tm = MASKS[mask]
    emask, *_ = JA._fused_inputs(jm, L, BLOCK)
    bits = bcsr_attn.pack_emask(torch.from_numpy(emask))
    nnzb, h, w = emask.shape
    assert bits.dtype == torch.int32 and bits.shape == (nnzb + 1, h, 1)
    back = ref.unpack_ebits(bits, w)
    np.testing.assert_array_equal(back[:nnzb].numpy(), emask != 0)
    assert not back[nnzb].any()
    assert torch.equal(A.mask_tensors(tm, L, BLOCK, "cpu").ebits, bits)


@pytest.mark.parametrize("w", [1, 31, 32, 33, 64, 100, 128])
def test_pack_emask_round_trips_every_bit_position(w):
    """Random masks across one to four words a row, bit 31 included (the
    int32 sign bit): unpack(pack(emask)) == emask exactly."""
    rng = np.random.default_rng(w)
    em = torch.from_numpy((rng.random((3, 5, w)) < 0.5).astype(np.float32))
    bits = bcsr_attn.pack_emask(em)
    assert bits.shape == (4, 5, -(-w // 32))
    assert torch.equal(ref.unpack_ebits(bits, w)[:3], em != 0)
    assert not ref.unpack_ebits(bits, w)[3].any()


@pytest.mark.parametrize("mask", ["banded", "local_global",
                                  "blockwise_causal"])
@pytest.mark.parametrize("L", [64, 61])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_b5_plain_reading_ebits_equals_jax_interpret_kernel(mask, L, cap):
    """B5's plain version fed the packed bits (as the kernel reads its
    mask) and following the kernel's two passes equals the JAX
    interpret-mode kernel within 1e-5, with and without ``cap``; the
    wrapper passes the bits through on the CPU."""
    jm, tm = MASKS[mask]
    emask, flat_idx, flat_col, meta = JA._fused_inputs(jm, L, BLOCK)
    rng = np.random.default_rng(L)
    q, k, v = (rng.standard_normal((4, L, 8)).astype(np.float32)
               for _ in range(3))
    kw = dict(n_block_rows=meta.n_block_rows, n_block_cols=meta.n_block_cols,
              block=BLOCK, scale=8 ** -0.5, cap=cap)
    want = np.asarray(jbk.bcsr_attn_fused(
        *map(jnp.asarray, (q, k, v)), emask, flat_idx, flat_col,
        interpret=True, **kw))
    mt = A.mask_tensors(tm, L, BLOCK, "cpu")
    bits = bcsr_attn.pack_emask(torch.from_numpy(emask))
    assert torch.equal(mt.ebits, bits)
    args = (*_t(q, k, v), mt.emask, mt.arrays.sddmm_flat_idx,
            mt.arrays.flat_col)
    got = ref.bcsr_attn_fused_ref(*args, ebits=bits, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(bcsr_attn.bcsr_attn_fused(*args, ebits=bits, **kw),
                       got)
    # the bits stand in for the mask: a zeroed f32 mask changes nothing
    assert torch.equal(ref.bcsr_attn_fused_ref(
        *args[:3], torch.zeros_like(args[3]), *args[4:], ebits=bits, **kw),
        got)


def test_b5_kernel_path_checks_the_bitmask():
    """The kernel path's argument checks (run before any launch) refuse a
    bitmask without the sentinel block or of the wrong dtype."""
    tm = MASKS["banded"][1]
    mt = A.mask_tensors(tm, 64, BLOCK, "cpu")
    q = torch.zeros(2, 64, 8)
    args = (q, q, q, mt.emask)
    sched = (mt.arrays.sddmm_flat_idx, mt.arrays.flat_col,
             mt.meta.n_block_rows, mt.meta.n_block_cols, BLOCK)
    assert bcsr_attn._check(*args, mt.ebits, *sched) == mt.meta.max_bpr
    with pytest.raises(ValueError, match="sentinel"):
        bcsr_attn._check(*args, mt.ebits[:-1], *sched)
    with pytest.raises(ValueError, match="ebits"):
        bcsr_attn._check(*args, mt.ebits.long(), *sched)


def test_b5_empty_block_row_zero_context():
    """JAX's test_fused_empty_block_row_zero_context on the port's plain
    version, against JAX's interpret-mode kernel."""
    L, d, h = 8, 4, 4
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, L, d)).astype(np.float32)
               for _ in range(3))
    emask = np.ones((1, h, h), np.float32)
    flat_idx = np.array([0, 1], np.int32)      # row 1 -> sentinel (nnzb=1)
    flat_col = np.array([0, 0], np.int32)
    kw = dict(n_block_rows=2, n_block_cols=2, block=(h, h), scale=0.5)
    want = np.asarray(jbk.bcsr_attn_fused(
        *map(jnp.asarray, (q, k, v)), emask, flat_idx, flat_col,
        interpret=True, **kw))
    got = bcsr_attn.bcsr_attn_fused(
        *_t(q, k, v), torch.from_numpy(emask), torch.from_numpy(flat_idx),
        torch.from_numpy(flat_col), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[0, h:] == 0).all()


def test_b5_wrapper_refuses_a_device_without_a_kernel():
    t = torch.zeros(1, 8, 4, device="meta")
    idx = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bcsr_attn.bcsr_attn_fused(t, t, t, torch.zeros(1, 8, 8,
                                                       device="meta"),
                                  idx, idx, n_block_rows=1, n_block_cols=1,
                                  block=(8, 8), scale=1.0)


# ================================================ block_sparse_attention
@pytest.mark.parametrize("mask", ["banded", "local_global",
                                  "blockwise_causal"])
@pytest.mark.parametrize("L", [64, 61])
@pytest.mark.parametrize("backend", ["fused", "xla", "nnz_stream",
                                     "row_loop"])
def test_block_sparse_attention_equals_jax(mask, L, backend):
    """Every port path (B5's plain version; the composed path on each ops
    backend's plain versions) against JAX's composed path, 1e-5."""
    jm, tm = MASKS[mask]
    q, k, v = _qkv(L, seed=L + len(mask))
    want = np.asarray(JA.block_sparse_attention(
        *map(jnp.asarray, (q, k, v)),
        JA.AttnSparsitySpec(mask=jm, block=BLOCK, backend="xla")))
    spec = A.AttnSparsitySpec(mask=tm, block=BLOCK, backend=backend)
    assert A.resolve_attn_impl(spec, L, 8, device="cpu") == \
        ("fused" if backend == "fused" else "composed")
    got = A.block_sparse_attention(*_t(q, k, v), spec)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_equals_jax_fused_kernel_with_cap():
    """Capped attention through B5's plain version against JAX's fused
    interpret-mode kernel (the JAX package's carve-out: float tolerance)."""
    jm, tm = MASKS["local_global"]
    q, k, v = _qkv(64)
    want = np.asarray(JA.block_sparse_attention(
        *map(jnp.asarray, (q, k, v)),
        JA.AttnSparsitySpec(mask=jm, block=BLOCK, backend="fused",
                            interpret=True), cap=30.0))
    got = A.block_sparse_attention(
        *_t(q, k, v), A.AttnSparsitySpec(mask=tm, block=BLOCK,
                                         backend="fused"), cap=30.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_equals_composed_on_the_cpu():
    """The fused == composed pin inside the port, on the CPU: the plain
    versions sum in different orders (B5's plain version over [slot, w]
    tiles, block_softmax block by block, the SpMM's index_add), so they
    agree to float tolerance, not bit for bit (ROADMAP C carve-out 2)."""
    for _, tm in MASKS.values():
        q, k, v = _t(*_qkv(61))
        f = A.block_sparse_attention(q, k, v, A.AttnSparsitySpec(
            mask=tm, block=BLOCK, backend="fused"))
        c = A.block_sparse_attention(q, k, v, A.AttnSparsitySpec(
            mask=tm, block=BLOCK, backend="xla"))
        np.testing.assert_allclose(f.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_attention_grads(mask, B, H):
    """``jax.grad`` of the sum of squares of JAX's attention (``xla``)
    at ``_qkv(64, B=B, H=H, seed=3)``, under ``jax.jit`` (a tenth of the
    op-by-op time): numpy (dq, dk, dv)."""
    jm, _ = MASKS[mask]

    def jloss(q, k, v):
        return jnp.sum(JA.block_sparse_attention(
            q, k, v, JA.AttnSparsitySpec(mask=jm, block=BLOCK,
                                         backend="xla")) ** 2)
    grads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, _qkv(64, B=B, H=H, seed=3)))
    return tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("mask", ["banded", "blockwise_causal"])
@pytest.mark.parametrize("backend", ["fused", "nnz_stream"])
def test_gradients_equal_jax_grad(mask, backend):
    """Through the fused Function (composed backward over all G = B * H
    instances at once, as JAX's ``vmap``) and the composed path, against
    ``jax.grad`` of JAX's attention, at G = 4 (B = H = 2) and G = 3 (B =
    1, H = 3: the folded heads a strided view): rtol = atol = 1e-5
    (``test_attn_fused.py``'s gradient tolerance)."""
    _, tm = MASKS[mask]
    for B, H in ((2, 2), (1, 3)):
        q, k, v = _qkv(64, B=B, H=H, seed=3)
        want = _jax_attention_grads(mask, B, H)
        tq, tk, tv = _t(q, k, v, grad=True)
        out = A.block_sparse_attention(tq, tk, tv, A.AttnSparsitySpec(
            mask=tm, block=BLOCK, backend=backend))
        (out ** 2).sum().backward()
        for got, w in zip((tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)
            assert float(got.abs().sum()) > 0


# ========================================================== dispatch rules
def test_resolve_attn_impl_rules_equal_jax():
    for (jm, tm), L in ((MASKS["banded"], 64),
                        (MASKS["blockwise_causal"], 61)):
        for backend in ("fused", "auto", "xla", "pallas", "row_loop",
                        "dense"):
            for shards in (0, 2):
                j = JA.resolve_attn_impl(JA.AttnSparsitySpec(
                    mask=jm, block=BLOCK, backend=backend, shards=shards,
                    interpret=True), L, 8)
                t = A.resolve_attn_impl(A.AttnSparsitySpec(
                    mask=tm, block=BLOCK, backend=backend, shards=shards),
                    L, 8, device="cpu")
                assert t == j, (backend, shards)


@pytest.fixture
def jax_oracle(monkeypatch):
    """Unlock the monitored JAX functions (ROADMAP C1), test-side only."""
    from repro.obs import jaxmon
    monkeypatch.setattr(jaxmon, "_trace_active",
                        lambda: not jax._src.core.trace_state_clean())


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_scores_raise_naming_a5(jax_oracle, shards):
    """(The name dates from before the partitioned path, when this raised.)
    ``AttnSparsitySpec(shards=S)`` runs composed, the context product over
    the mask's row partition: forward and gradients against JAX's sharded
    attention within 1e-5, and the partition's host data equal to JAX's
    ``_mask_sharded``."""
    jm, tm = MASKS["banded"]
    q, k, v = _qkv(64, seed=5)
    jspec = JA.AttnSparsitySpec(mask=jm, block=BLOCK, backend="xla",
                                shards=shards)
    spec = A.AttnSparsitySpec(mask=tm, block=BLOCK, backend="fused",
                              shards=shards)
    assert A.resolve_attn_impl(spec, 64, 8, device="cpu") == "composed"
    sharr, smeta = A.mask_sharded(tm, 64, BLOCK, shards, "cpu")
    j_sharr, j_smeta = JA._mask_sharded(jm, 64, BLOCK, shards)
    assert dataclasses.asdict(smeta) == dataclasses.asdict(j_smeta)
    for name in j_sharr._fields:
        np.testing.assert_array_equal(getattr(sharr, name).numpy(),
                                      np.asarray(getattr(j_sharr, name)),
                                      err_msg=name)
    assert A.mask_sharded(tm, 64, BLOCK, shards, "cpu")[0] is sharr

    def jloss(q, k, v):
        return jnp.sum(JA.block_sparse_attention(q, k, v, jspec) ** 2)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = JA.block_sparse_attention(jq, jk, jv, jspec)
    want_g = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = A.block_sparse_attention(tq, tk, tv, spec)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    (out ** 2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_attn_pick_and_key_equal_jax_plus_device():
    """The ``attn`` family is pickable: its fingerprint key is JAX's v7 key
    plus ``|dev=``, its pick the argmin of the port's (H100) model over the
    two variants, both of which run kernels; ``tune(op="attn")`` raises."""
    jmeta = JA.attention_mask_meta(JA.banded(24), 64, BLOCK)
    tmeta = A.attention_mask_meta(A.banded(24), 64, BLOCK)
    for n in (8, 128):
        assert autotune.fingerprint(tmeta, n, op="attn",
                                    device="NVIDIA H100").key() == \
            jat.fingerprint(jmeta, n, op="attn").key() + "|dev=NVIDIA H100"
        pick = autotune.get_autotuner().pick(tmeta, n, op="attn",
                                             device="cpu")
        times = {name: autotune.get_variant(name).model_time(tmeta, n, 0)
                 for name in autotune.variant_names("attn")}
        assert pick.variant == min(times, key=times.get)
        assert autotune.get_variant(pick.variant).is_kernel
    assert pick is autotune.get_autotuner().pick(tmeta, 128, op="attn",
                                                 device="cpu")
    assert autotune.analytic_choice(tmeta, 8, op="attn").variant in \
        ("attn_fused", "attn_composed")
    with pytest.raises(ValueError, match="no measured sweep"):
        autotune.get_autotuner().tune(A.attention_mask_bcsr(
            A.banded(24), 64, BLOCK), 8, op="attn", device="cpu")
    spec = A.AttnSparsitySpec(mask=A.banded(24), block=BLOCK, backend="auto")
    assert A.resolve_attn_impl(spec, 64, 8, device="cpu") == \
        ("fused" if autotune.get_autotuner().pick(
            tmeta, 8, op="attn", device="cpu").variant == "attn_fused"
         else "composed")


# ================================================================= configs
@pytest.mark.parametrize("arch", [ARCH, ARCH + ":smoke"])
def test_config_fields_equal_jax(arch):
    """Every field equal to JAX's but the backends (FFN ``nnz_stream``,
    attention ``fused``) and ``interpret``; GQA in the smoke view."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    j, t = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    j_ffn, t_ffn = j.pop("ffn_sparsity"), t.pop("ffn_sparsity")
    j_attn, t_attn = j.pop("attn_sparsity"), t.pop("attn_sparsity")
    assert t == j
    assert (t_ffn.pop("backend"), t_attn.pop("backend")) == \
        ("nnz_stream", "fused")
    for spec in (j_ffn, j_attn):
        spec.pop("backend")
        spec.pop("interpret")
    assert (t_ffn, t_attn) == (j_ffn, j_attn)
    assert tcfg.supports_long_context == jcfg.supports_long_context is True
    assert tcfg.has_decode == jcfg.has_decode
    if arch.endswith(":smoke"):
        assert (tcfg.n_heads, tcfg.n_kv_heads) == (4, 2)
        assert t_attn["mask"]["bandwidth"] == 32
        assert t_attn["block"] == (16, 16)


@pytest.mark.parametrize("arch", ["smat-ffn-1.3b", ARCH])
def test_shape_cells_and_applicability_equal_jax(arch):
    assert {n: dataclasses.asdict(c) for n, c in tbase.SHAPES.items()} == \
        {n: dataclasses.asdict(c) for n, c in jbase.SHAPES.items()}
    for name, cell in tbase.SHAPES.items():
        got = tbase.cell_applicable(get_config(arch), cell)[0]
        want = jbase.cell_applicable(jax_get_config(arch),
                                     jbase.SHAPES[name])[0]
        assert got == want, name


# =================================================================== model
def _off(cfg):
    return dataclasses.replace(cfg, dtype="float32",
                               attn_sparsity=dataclasses.replace(
                                   cfg.attn_sparsity, paged_decode="off"))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _off(jax_get_config(ARCH + ":smoke")), \
        _off(get_config(ARCH + ":smoke"))
    jparams = JT.init_params(jcfg, seed=0)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, np_params, convert.params_from_jax(
        tcfg, np_params, "cpu")


def test_params_from_jax_carries_the_attention_arch(pair):
    """The attention weights are dense and named as in smat-ffn-1.3b: every
    leaf of the JAX tree lands in the port's model unchanged."""
    _, tcfg, _, np_params, model = pair
    blocks = np_params["blocks"]
    for i, blk in enumerate(model.blocks):
        for name, value in blocks["attn"].items():
            np.testing.assert_array_equal(
                getattr(blk.attn, name).detach().numpy(), value[i])
        for name, layer in blocks["mlp"].items():
            np.testing.assert_array_equal(
                getattr(blk.mlp, name).vals.detach().numpy(),
                layer["vals"][i])
    np.testing.assert_array_equal(model.embed.detach().numpy(),
                                  np_params["embed"])


def test_smoke_forward_logits_match_jax(pair):
    """L = 40 (three 16-row blocks, banded(32): a sparse mask), float32:
    logits and loss within 1e-4."""
    jcfg, tcfg, jparams, _, model = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, 40), dtype=np.int32)
    labels = rng.integers(0, tcfg.vocab_size, size=(2, 40), dtype=np.int32)
    j_logits, _, _ = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    j_loss = JT.lm_loss(jcfg, j_logits, jnp.asarray(labels))
    with torch.inference_mode():
        t_logits, _, _ = model({"tokens": torch.from_numpy(tokens).long()})
        t_loss = T.lm_loss(tcfg, t_logits, torch.from_numpy(labels))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4,
                               atol=1e-4)


def test_sharded_smoke_forward_and_grads_match_jax(jax_oracle):
    """smat-attn-1.3b:smoke with ``AttnSparsitySpec(shards=2)`` (the
    context products over the mask's row partition, composed), float32:
    logits within 1e-4 of JAX's forward, and every gradient within 1e-4 x
    its max|grad| of ``jax.grad``."""
    def sharded(cfg):
        return dataclasses.replace(_off(cfg), attn_sparsity=dataclasses.replace(
            cfg.attn_sparsity, shards=2, paged_decode="off"))
    jcfg, tcfg = sharded(jax_get_config(ARCH + ":smoke")), \
        sharded(get_config(ARCH + ":smoke"))
    jparams = JT.init_params(jcfg, seed=0)
    model = convert.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                    "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, 40), dtype=np.int32)
    labels = rng.integers(0, tcfg.vocab_size, size=(2, 40), dtype=np.int32)

    def jloss(p):
        logits, _, _ = JT.forward(jcfg, p, {"tokens": jnp.asarray(tokens)})
        return JT.lm_loss(jcfg, logits, jnp.asarray(labels)), logits
    (j_loss, j_logits), j_grads = jax.value_and_grad(
        jloss, has_aux=True, allow_int=True)(
        jparams)
    t_logits, _, _ = model({"tokens": torch.from_numpy(tokens).long()})
    t_loss = T.lm_loss(tcfg, t_logits, torch.from_numpy(labels))
    t_loss.backward()
    np.testing.assert_allclose(t_logits.detach().numpy(),
                               np.asarray(j_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf = j_grads[parts[0]]
        if parts[0] == "blocks":
            for key in parts[2:]:
                leaf = leaf[key]
            leaf = leaf[int(parts[1])]
        want = np.asarray(leaf)
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-30), (name, err)


def test_smoke_prefill_then_decode_matches_jax_loop(pair):
    """Prefill a 40-token prompt (B5's plain version), then 8 greedy decode
    steps (the dense-bias decode with the mask bias, paged_decode="off")
    against a JAX prefill + decode_step loop: logits within 1e-4 at every
    step, identical tokens."""
    jcfg, tcfg, jparams, _, model = pair
    prompt = np.random.default_rng(2).integers(0, tcfg.vocab_size,
                                               size=(1, 40), dtype=np.int32)
    j_logits, j_cache = JT.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(prompt)}, 64)
    with torch.inference_mode():
        t_logits, t_cache = T.prefill(tcfg, model, {
            "tokens": torch.from_numpy(prompt).long()}, 64)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   rtol=1e-4, atol=1e-4)
        tok_j = int(np.asarray(j_logits)[0, -1].argmax())
        tok_t = int(t_logits[0, -1].argmax())
        toks_j, toks_t = [tok_j], [tok_t]
        for pos in range(40, 48):
            j_logits, j_cache = JT.decode_step(
                jcfg, jparams, j_cache, jnp.asarray([tok_j], jnp.int32),
                jnp.asarray(pos, jnp.int32))
            t_logits, t_cache = T.decode_step(tcfg, model, t_cache,
                                              torch.tensor([tok_t]), pos)
            np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"pos {pos}")
            tok_j = int(np.asarray(j_logits)[0].argmax())
            tok_t = int(t_logits[0].argmax())
            toks_j.append(tok_j)
            toks_t.append(tok_t)
    assert toks_t == toks_j


def test_resolved_page_table_decodes_paged_and_matches_jax(pair,
                                                           monkeypatch):
    """With the registered paged_decode="auto", the :smoke view resolves a
    page table at cache 64 (banded(32), block 16: 3 of 4 pages), and decode
    reads KV through it: a 40-token prefill, then 8 greedy decode steps,
    against the JAX prefill + decode_step loop with the same mode, whose
    ``_paged_decode`` is unlocked test-side (ROADMAP C1): logits within 1e-4
    at every step, identical tokens, and the paged branch taken."""
    from repro.obs import jaxmon
    from repro_torch.obs import shapemon
    monkeypatch.setattr(jaxmon, "_trace_active",
                        lambda: not jax._src.core.trace_state_clean())
    jcfg, tcfg, jparams, _, model = pair
    jcfg, tcfg = (dataclasses.replace(c, attn_sparsity=dataclasses.replace(
        c.attn_sparsity, paged_decode="auto")) for c in (jcfg, tcfg))
    assert TL._decode_pages(tcfg, None, 64) is not None
    assert JL._decode_pages(jcfg, None, 64) is not None
    prompt = np.random.default_rng(2).integers(0, tcfg.vocab_size,
                                               size=(1, 40), dtype=np.int32)
    j_logits, j_cache = JT.prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(prompt)}, 64)
    shapemon.reset("models.paged_decode")
    with torch.inference_mode():
        t_logits, t_cache = T.prefill(tcfg, model, {
            "tokens": torch.from_numpy(prompt).long()}, 64)
        tok_j = int(np.asarray(j_logits)[0, -1].argmax())
        tok_t = int(t_logits[0, -1].argmax())
        toks_j, toks_t = [tok_j], [tok_t]
        for pos in range(40, 48):
            j_logits, j_cache = JT.decode_step(
                jcfg, jparams, j_cache, jnp.asarray([tok_j], jnp.int32),
                jnp.asarray(pos, jnp.int32))
            t_logits, t_cache = T.decode_step(tcfg, model, t_cache,
                                              torch.tensor([tok_t]), pos)
            np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"pos {pos}")
            tok_j = int(np.asarray(j_logits)[0].argmax())
            tok_t = int(t_logits[0].argmax())
            toks_j.append(tok_j)
            toks_t.append(tok_t)
    assert toks_t == toks_j
    assert shapemon.trace_count("models.paged_decode") == 1


@pytest.mark.parametrize("module", ["repro_torch.core.attention_mask",
                                    "repro_torch.kernels.bcsr_attn",
                                    "repro_torch.models.attention"])
def test_docstring_examples(module):
    res = doctest.testmod(importlib.import_module(module))
    assert res.attempted > 0 and res.failed == 0, res
