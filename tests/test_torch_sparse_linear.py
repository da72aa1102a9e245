"""The port's block-sparse linear layer against the JAX package's: metas and
``vals`` exactly equal (both draw them from numpy seeds), outputs within
1e-5 in f32 (different summation order)."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import sparse_linear as jsl
from repro.kernels import autotune as jat
from repro.obs import jaxmon
from repro_torch.core import sparse_linear as tsl
from repro_torch.kernels import autotune as tat

CASES = [  # (seed, in_dim, out_dim, density, block)
    (7919, 128, 256, 0.3, (16, 16)),
    (15838, 256, 128, 0.3, (16, 16)),
    (3, 96, 160, 0.2, (16, 32)),
    (5, 70, 50, 0.5, (16, 16)),          # unaligned dims
]


def _specs(density, block, backend="xla"):
    return (jsl.SparsitySpec(density=density, block=block, backend=backend),
            tsl.SparsitySpec(density=density, block=block))


@pytest.mark.parametrize("seed,in_dim,out_dim,density,block", CASES)
def test_meta_and_init_equal(seed, in_dim, out_dim, density, block):
    jspec, tspec = _specs(density, block)
    j_meta = jsl.sparse_linear_meta(seed, in_dim, out_dim, jspec)
    t_meta = tsl.sparse_linear_meta(seed, in_dim, out_dim, tspec)
    assert dataclasses.asdict(t_meta) == dataclasses.asdict(j_meta)
    assert tsl._nnzb_for(tspec, out_dim, in_dim) == \
        jsl._nnzb_for(jspec, out_dim, in_dim)
    j_params, j_meta2 = jsl.init_sparse_linear(seed, in_dim, out_dim, jspec,
                                               dtype=jnp.float32)
    t_params, t_meta2 = tsl.init_sparse_linear(seed, in_dim, out_dim, tspec,
                                               torch.float32, device="cpu")
    assert t_meta2 == t_meta
    assert dataclasses.asdict(t_meta2) == dataclasses.asdict(j_meta2)
    for name, value in j_params.items():
        np.testing.assert_array_equal(t_params[name].numpy(),
                                      np.asarray(value), err_msg=name)


@pytest.mark.parametrize("seed,in_dim,out_dim,density,block", CASES)
@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_apply_matches_jax(seed, in_dim, out_dim, density, block,
                           jax_backend):
    jspec, tspec = _specs(density, block, backend=jax_backend)
    jspec = dataclasses.replace(jspec, interpret=True, bn=128)
    j_params, j_meta = jsl.init_sparse_linear(seed, in_dim, out_dim, jspec,
                                              dtype=jnp.float32)
    t_params, t_meta = tsl.init_sparse_linear(seed, in_dim, out_dim, tspec,
                                              torch.float32, device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (2, 3, in_dim)).astype(np.float32)
    want = jsl.apply_sparse_linear(j_params, j_meta, jnp.asarray(x), jspec)
    layer = tsl.SparseLinear(t_params, t_meta, tspec)
    with torch.no_grad():
        got = tsl.apply_sparse_linear(t_params, t_meta, torch.from_numpy(x),
                                      tspec)
        by_module = layer(torch.from_numpy(x))
    assert got.shape == (2, 3, out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(by_module, got, rtol=0, atol=0)


def test_merge_metas_equal_and_checked():
    _, tspec = _specs(0.3, (16, 16))
    jspec, _ = _specs(0.3, (16, 16))
    seeds = [7919 * (i + 1) for i in range(3)]
    t_merged = tsl.merge_sparse_metas(
        tsl.sparse_linear_meta(s, 128, 256, tspec) for s in seeds)
    j_merged = jsl.merge_sparse_metas(
        [jsl.sparse_linear_meta(s, 128, 256, jspec) for s in seeds])
    assert dataclasses.asdict(t_merged) == dataclasses.asdict(j_merged)
    with pytest.raises(ValueError, match="different static structure"):
        tsl.merge_sparse_metas([tsl.sparse_linear_meta(1, 128, 256, tspec),
                                tsl.sparse_linear_meta(1, 256, 128, tspec)])


@pytest.fixture
def jax_oracle(monkeypatch):
    """Unlock the monitored JAX functions (ROADMAP C1), test-side only."""
    monkeypatch.setattr(jaxmon, "_trace_active",
                        lambda: not jax._src.core.trace_state_clean())


def test_layer_buffers_and_unported_options(jax_oracle):
    """(The name dates from before the partitioned path, when a sharded
    spec raised.)  A layer's parameter and buffers, unsharded and sharded; a
    ``shards=2`` spec builds the JAX package's partition exactly and
    applies within 1e-5 of JAX."""
    jspec, tspec = _specs(0.3, (16, 16))
    params, meta = tsl.init_sparse_linear(1, 64, 64, tspec, torch.float32,
                                          device="cpu")
    layer = tsl.SparseLinear(params, meta, tspec)
    assert [n for n, _ in layer.named_parameters()] == ["vals"]
    assert set(dict(layer.named_buffers())) == set(tsl.BUFFER_FIELDS)
    jspec, tspec = (dataclasses.replace(jspec, shards=2),
                    dataclasses.replace(tspec, shards=2))
    j_params, j_meta = jsl.init_sparse_linear(1, 64, 96, jspec,
                                              dtype=jnp.float32)
    params, meta = tsl.init_sparse_linear(1, 64, 96, tspec, torch.float32,
                                          device="cpu")
    assert dataclasses.asdict(meta) == dataclasses.asdict(j_meta)
    assert tsl.sparse_linear_meta(1, 64, 96, tspec) == meta
    assert set(j_params) | set(tsl.SHARDED_BUFFER_FIELDS) == set(params)
    for name, value in j_params.items():
        np.testing.assert_array_equal(params[name].numpy(),
                                      np.asarray(value), err_msg=name)
    layer = tsl.SparseLinear(params, meta, tspec)
    assert [n for n, _ in layer.named_parameters()] == ["vals"]
    assert set(dict(layer.named_buffers())) == \
        set(tsl.SHARDED_BUFFER_FIELDS)
    x = np.random.default_rng(1).standard_normal((2, 3, 64)).astype(
        np.float32)
    want = jsl.apply_sparse_linear(j_params, j_meta, jnp.asarray(x), jspec)
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _sharded_specs(shards, backend="xla"):
    base = dict(density=0.3, block=(16, 16))
    return (jsl.SparsitySpec(**base, backend="xla", shards=shards),
            tsl.SparsitySpec(**base, backend=backend, shards=shards))


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("backend", ["nnz_stream", "row_loop", "auto"])
def test_sharded_layer_matches_unsharded(shards, backend):
    """The twin of ``tests/test_dist_spmm.py``'s sharded == unsharded
    ``SparseLinear``: forward and the ``vals`` gradient within 1e-5 / 1e-4
    of the unsharded layer on the same seed, for every port backend."""
    _, spec_s = _sharded_specs(shards, backend)
    spec_0 = dataclasses.replace(spec_s, shards=0)
    d, f = 96, 160
    p0, m0 = tsl.init_sparse_linear(11, d, f, spec_0, torch.float32,
                                    device="cpu")
    ps, ms = tsl.init_sparse_linear(11, d, f, spec_s, torch.float32,
                                    device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, d)).astype(np.float32))
    outs = []
    for params, meta, spec in ((p0, m0, spec_0), (ps, ms, spec_s)):
        layer = tsl.SparseLinear(params, meta, spec)
        y = layer(x)
        (y ** 2).sum().backward()
        outs.append((y.detach(), layer.vals.grad))
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(outs[1][1].numpy(), outs[0][1].numpy(),
                               rtol=1e-5, atol=1e-4)


def test_sharded_init_shapes_match_jax_specs():
    """The dims-only shapes (``shard_shapes``) the JAX package's
    ``sparse_linear_specs`` gives: every seed's layer lands on them."""
    jspec, tspec = _sharded_specs(4)
    d, f = 96, 160
    specs, smeta = jsl.sparse_linear_specs(d, f, jspec, dtype=jnp.float32)
    assert tsl.shard_shapes(tspec, f, d) == jsl.shard_shapes(jspec, f, d)
    for seed in (11, 12, 13):
        params, meta = tsl.init_sparse_linear(seed, d, f, tspec,
                                              torch.float32, device="cpu")
        for name, sds in specs.items():
            assert tuple(params[name].shape) == sds.shape, name
        assert (meta.rows_per_shard, meta.nnzb_per_shard,
                meta.nnzb_t_per_shard) == (smeta.rows_per_shard,
                                           smeta.nnzb_per_shard,
                                           smeta.nnzb_t_per_shard)


def test_auto_shards_resolve_as_jax():
    """``shards="auto"`` resolves through each package's shard-count pick
    with the device count as its cap (1 on this machine: S = 1 in both),
    and with the same measured entry in both tuners to that entry; the
    resolved layer equals JAX's, and its apply is the same at chunk depth
    1 and 2, bit for bit."""
    jspec, tspec = _sharded_specs("auto")
    d, f = 96, 160
    assert tsl.is_sharded(tspec) and jsl.is_sharded(jspec)
    assert not tsl.is_sharded(dataclasses.replace(tspec, shards=0))
    assert tsl.resolved_shards(tspec, f, d, device="cpu") == \
        jsl.resolved_shards(jspec, f, d) == 1
    for ms in (1, 2, 4):
        assert tsl.resolved_shards(tspec, f, d, max_shards=ms,
                                   device="cpu") >= 1
    j_params, j_meta = jsl.init_sparse_linear(11, d, f, jspec,
                                              dtype=jnp.float32)
    params, meta = tsl.init_sparse_linear(11, d, f, tspec, torch.float32,
                                          device="cpu")
    assert dataclasses.asdict(meta) == dataclasses.asdict(j_meta)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, d)).astype(np.float32))
    y2 = tsl.apply_sparse_linear(params, meta, x, tspec)
    y1 = tsl.apply_sparse_linear(params, meta, x, dataclasses.replace(
        tspec, shard_chunks=1))
    assert torch.equal(y1, y2)
    # the same measured decision in both tuners (max_shards 8)
    jt, tt = jat.Autotuner(), tat.Autotuner()
    h, w = tspec.block
    for tuner, mod, kw in ((jt, jat, {}), (tt, tat, {"device": "cpu"})):
        nnzb = tsl._nnzb_for(tspec, f, d)
        pseudo = mod.ops.SparseMeta(
            shape=(f, d), block=tspec.block, n_block_rows=-(-f // h),
            n_block_cols=-(-d // w), nnzb=nnzb, nnzb_t=nnzb)
        tuner.put_shards(mod.fingerprint(pseudo, 512, n_chunks=2, **kw), 8,
                         mod.ShardChoice(2, source="measured"),
                         persist=False)
    jat.set_autotuner(jt)
    tat.set_autotuner(tt)
    try:
        assert tsl.resolved_shards(tspec, f, d, max_shards=8,
                                   device="cpu") == \
            jsl.resolved_shards(jspec, f, d, max_shards=8) == 2
    finally:
        jat.set_autotuner(None)
        tat.set_autotuner(None)


def test_sharded_metas_merge_as_jax():
    jspec, tspec = _sharded_specs(2)
    seeds = [7919 * (i + 1) for i in range(3)]
    t_merged = tsl.merge_sparse_metas(
        tsl.sparse_linear_meta(s, 128, 256, tspec) for s in seeds)
    j_merged = jsl.merge_sparse_metas(
        [jsl.sparse_linear_meta(s, 128, 256, jspec) for s in seeds])
    assert dataclasses.asdict(t_merged) == dataclasses.asdict(j_merged)
    with pytest.raises(ValueError, match="different static structure"):
        tsl.merge_sparse_metas([tsl.sparse_linear_meta(1, 128, 256, tspec),
                                tsl.sparse_linear_meta(1, 256, 128, tspec)])


@pytest.mark.parametrize("reorder", ["jaccard", "rcm", "shard_balance"])
def test_reordered_layer_equal_jax(reorder):
    """``SparsitySpec.reorder`` takes every row scheme (block-row
    granularity, ``shard_balance`` over ``reorder_shards`` bins): metas and
    every array equal JAX's, outputs within 1e-5 in f32."""
    seed, in_dim, out_dim = 7919, 128, 256
    jspec = jsl.SparsitySpec(density=0.3, block=(16, 16), backend="xla",
                             reorder=reorder, reorder_shards=4)
    tspec = tsl.SparsitySpec(density=0.3, block=(16, 16), backend="row_loop",
                             reorder=reorder, reorder_shards=4)
    j_params, j_meta = jsl.init_sparse_linear(seed, in_dim, out_dim, jspec,
                                              dtype=jnp.float32)
    t_params, t_meta = tsl.init_sparse_linear(seed, in_dim, out_dim, tspec,
                                              torch.float32, device="cpu")
    assert dataclasses.asdict(t_meta) == dataclasses.asdict(j_meta)
    assert tsl.sparse_linear_meta(seed, in_dim, out_dim, tspec) == t_meta
    for name, value in j_params.items():
        np.testing.assert_array_equal(t_params[name].numpy(),
                                      np.asarray(value), err_msg=name)
    x = np.random.default_rng(seed).standard_normal(
        (2, 3, in_dim)).astype(np.float32)
    want = jsl.apply_sparse_linear(j_params, j_meta, jnp.asarray(x), jspec)
    with torch.no_grad():
        got = tsl.apply_sparse_linear(t_params, t_meta, torch.from_numpy(x),
                                      tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
