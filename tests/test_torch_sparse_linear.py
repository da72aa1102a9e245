"""The port's block-sparse linear layer against the JAX package's: metas and
``vals`` exactly equal (both draw them from numpy seeds), outputs within
1e-5 in f32 (different summation order)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_linear as jsl
from repro_torch.core import sparse_linear as tsl

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


def test_layer_buffers_and_unported_options():
    _, tspec = _specs(0.3, (16, 16))
    params, meta = tsl.init_sparse_linear(1, 64, 64, tspec, torch.float32,
                                          device="cpu")
    layer = tsl.SparseLinear(params, meta, tspec)
    assert [n for n, _ in layer.named_parameters()] == ["vals"]
    assert set(dict(layer.named_buffers())) == set(tsl.BUFFER_FIELDS)
    with pytest.raises(NotImplementedError, match="not ported"):
        tsl.init_sparse_linear(1, 64, 64,
                               dataclasses.replace(tspec, shards=2),
                               device="cpu")


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
