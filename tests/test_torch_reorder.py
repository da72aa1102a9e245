"""The port's library path on the host against the JAX package's: the
``topology`` generators, CSR -> BCSR, the reorder schemes at both
granularities, the Jaccard clustering (native C path and numpy rounds), the
shard-balancing helpers and ``prepare(reorder=...)``.  All of it is host
data, so every array and meta must be EXACTLY equal."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import dataclasses

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import torch

from repro.core import bcsr as jb
from repro.core import native as jnative
from repro.core import permute as jperm
from repro.core import reorder as jreorder
from repro.core import topology as jtopo
from repro.kernels import ops as jops
from repro_torch.core import bcsr as tb
from repro_torch.core import native as tnative
from repro_torch.core import permute as tperm
from repro_torch.core import reorder as treorder
from repro_torch.core import topology as ttopo
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops


def _assert_csr_equal(got, want):
    got, want = got.tocsr(), want.tocsr()
    assert got.shape == want.shape
    for field in ("indptr", "indices", "data"):
        x, y = getattr(got, field), getattr(want, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def _assert_bcsr_equal(got, want):
    for field in ("vals", "col_ids", "row_ids", "rowptr"):
        x, y = getattr(got, field), getattr(want, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert tuple(got.shape) == tuple(want.shape)
    assert tuple(got.block) == tuple(want.block)


# ------------------------------------------------------------------ topology
@pytest.mark.parametrize("name", sorted(jtopo.SUITE))
def test_suite_matrices_equal(name):
    assert ttopo.SUITE[name][1:] == jtopo.SUITE[name][1:]
    _assert_csr_equal(ttopo.suite_matrix(name, seed=1),
                      jtopo.suite_matrix(name, seed=1))


@pytest.mark.parametrize("gen,kw", [
    ("band", dict(n=300, bandwidth=5)),
    ("band_pattern", dict(n=200, bandwidth=250)),
    ("band_pattern", dict(n=300, bandwidth=7)),
    ("power_law", dict(n=500, avg_nnz_row=4.0)),
    ("mesh2d", dict(side=13)),
    ("mesh3d", dict(side=6)),
    ("blocked_random", dict(n=777, nnz_target=9_000, cluster=40)),
])
def test_generators_equal(gen, kw):
    _assert_csr_equal(getattr(ttopo, gen)(seed=3, **kw),
                      getattr(jtopo, gen)(seed=3, **kw))


# ---------------------------------------------------------------- CSR / BCSR
def _csr(seed=0, n=300, m=260, density=0.03):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, m)).astype(np.float32)
    dense[rng.random((n, m)) > density] = 0
    return sp.csr_matrix(dense)


@pytest.mark.parametrize("block", [(16, 16), (8, 32), (32, 8)])
def test_from_scipy_to_scipy_and_stats_equal(block):
    csr = _csr()
    ja, ta = jb.from_scipy(csr, block), tb.from_scipy(csr, block)
    _assert_bcsr_equal(ta, ja)
    _assert_csr_equal(ta.to_scipy(), ja.to_scipy())
    assert ta.stats() == ja.stats()
    assert ta.block_bounds() == ja.block_bounds()
    assert ta.density == ja.density


def test_from_csr_sums_duplicates_like_jax():
    rows = np.array([0, 0, 5, 5, 17])
    cols = np.array([3, 3, 9, 9, 1])
    vals = np.arange(5, dtype=np.float32) + 1
    coo = sp.coo_matrix((vals, (rows, cols)), shape=(20, 20))
    csr = sp.csr_matrix((coo.data, (coo.row, coo.col)), shape=(20, 20))
    csr.has_canonical_format = False
    ja = jb.from_csr(csr.indptr, csr.indices, csr.data, (20, 20), (8, 8))
    ta = tb.from_csr(csr.indptr, csr.indices, csr.data, (20, 20), (8, 8))
    _assert_bcsr_equal(ta, ja)


# --------------------------------------------------------------- the schemes
ROW_SCHEMES = ("identity", "jaccard", "rcm", "shard_balance")


def _operands():
    clustered = jtopo.blocked_random(n=384, nnz_target=6_000, cluster=32,
                                     seed=5)
    partial = _csr(5, 120, 64, 0.1).toarray()   # a partial last block-row
    partial[16:32] = 0                          # and an empty one
    return [
        ("clustered", lambda: (jb.from_scipy(clustered, (16, 16)),
                               tb.from_scipy(clustered, (16, 16)))),
        ("partial_last_row", lambda: (jb.from_dense(partial, (16, 16)),
                                      tb.from_dense(partial, (16, 16)))),
        ("rect_odd_blocks", lambda: (
            jb.random_bcsr(2, (96, 160), (8, 32), 0.3),
            tb.random_bcsr(2, (96, 160), (8, 32), 0.3))),
    ]


OPERANDS = _operands()


def test_schemes_table_equal():
    assert sorted(tperm.SCHEMES) == sorted(jperm.SCHEMES)
    assert treorder.SCHEMES is tperm.SCHEMES


@pytest.mark.parametrize("granularity", ["element", "block_row"])
@pytest.mark.parametrize("scheme", ROW_SCHEMES)
@pytest.mark.parametrize("name,make", OPERANDS, ids=[n for n, _ in OPERANDS])
def test_permute_bcsr_equal(name, make, scheme, granularity):
    ja, ta = make()
    kw = dict(tau=0.6, max_candidates=128, n_shards=4,
              granularity=granularity)
    j_out, j_perm = jperm.permute_bcsr(ja, scheme, **kw)
    t_out, t_perm = tperm.permute_bcsr(ta, scheme, **kw)
    assert t_perm.dtype == j_perm.dtype
    np.testing.assert_array_equal(t_perm, j_perm)
    _assert_bcsr_equal(t_out, j_out)


@pytest.mark.parametrize("granularity", ["element", "block_row"])
def test_column_permuting_scheme_rejected(granularity):
    ta = tb.random_bcsr(3, (64, 64), (16, 16), 0.3)
    ja = jb.random_bcsr(3, (64, 64), (16, 16), 0.3)
    want = "column permutation" if granularity == "element" else \
        "no block-row form"
    for permute_bcsr, a in ((jperm.permute_bcsr, ja),
                            (tperm.permute_bcsr, ta)):
        with pytest.raises(ValueError, match=want):
            permute_bcsr(a, "jaccard_rows_cols", granularity=granularity)
    with pytest.raises(ValueError, match="column permutation"):
        tops.prepare(ta, torch.float32, reorder="jaccard_rows_cols",
                     device="cpu")
    with pytest.raises(ValueError, match="unknown reorder scheme"):
        tperm.permute_bcsr(ta, "nope")


def test_reorder_dispatch_and_references_equal():
    csr = jtopo.blocked_random(n=256, nnz_target=3_000, cluster=32, seed=2)
    for scheme in ("identity", "jaccard", "rcm", "shard_balance"):
        np.testing.assert_array_equal(
            treorder.reorder(csr, scheme, block_w=16, tau=0.7, n_shards=4),
            jreorder.reorder(csr, scheme, block_w=16, tau=0.7, n_shards=4))
    trp, tcp = treorder.reorder(csr, "jaccard_rows_cols", block_w=16)
    jrp, jcp = jreorder.reorder(csr, "jaccard_rows_cols", block_w=16)
    np.testing.assert_array_equal(trp, jrp)
    np.testing.assert_array_equal(tcp, jcp)
    np.testing.assert_array_equal(
        treorder.jaccard_rows(csr, block_w=16, tau=0.6, max_candidates=50),
        jreorder.jaccard_rows(csr, block_w=16, tau=0.6, max_candidates=50))
    t_rc = treorder.jaccard_rows_cols(csr, (16, 16), tau=0.6)
    j_rc = jreorder.jaccard_rows_cols(csr, (16, 16), tau=0.6)
    for x, y in zip(t_rc, j_rc):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(treorder.rcm(csr), jreorder.rcm(csr))
    ind = jperm._block_indicator(csr, (16, 16))
    np.testing.assert_array_equal(
        treorder.shard_balance(None, ind.indptr, 3),
        jreorder.shard_balance(None, ind.indptr, 3))
    perm = treorder.reorder(csr, "jaccard", block_w=16)
    _assert_csr_equal(treorder.apply_perm(csr, perm, perm[::-1]),
                      jreorder.apply_perm(csr, perm, perm[::-1]))
    with pytest.raises(ValueError, match="unknown reorder scheme"):
        treorder.reorder(csr, "nope")


# -------------------------------------------------- native and numpy Jaccard
CLUSTER_CASES = [(0.7, None), (0.5, 256), (0.9, 64)]


def test_native_builds_into_the_build_dir():
    assert tnative.library_path().parent == _build.BUILD_DIR
    assert tnative.get_kernel() is not None        # gcc is installed here
    assert tnative.library_path().exists()


@pytest.mark.parametrize("tau,max_candidates", CLUSTER_CASES)
def test_native_clustering_equals_jax_and_the_reference(tau,
                                                        max_candidates):
    if jnative.get_kernel() is None:
        pytest.fail("the JAX package's native kernel did not build")
    csr = jtopo.blocked_random(n=1024, nnz_target=20_000, cluster=32,
                               seed=3)
    got = tperm.jaccard_rows_fast(csr, block_w=16, tau=tau,
                                  max_candidates=max_candidates)
    np.testing.assert_array_equal(got, jperm.jaccard_rows_fast(
        csr, block_w=16, tau=tau, max_candidates=max_candidates))
    np.testing.assert_array_equal(got, treorder.jaccard_rows(
        csr, block_w=16, tau=tau, max_candidates=max_candidates))


@pytest.mark.parametrize("tau,max_candidates", CLUSTER_CASES)
def test_numpy_rounds_equal_jax(monkeypatch, tau, max_candidates):
    """``REPRO_NO_NATIVE_JACCARD=1`` pins both packages to the numpy
    rounds, whose clustering may differ from the reference's."""
    monkeypatch.setenv("REPRO_NO_NATIVE_JACCARD", "1")
    assert tnative.get_kernel() is None and jnative.get_kernel() is None
    csr = jtopo.blocked_random(n=768, nnz_target=12_000, cluster=32, seed=4)
    got = tperm.jaccard_rows_fast(csr, block_w=16, tau=tau,
                                  max_candidates=max_candidates)
    assert sorted(got.tolist()) == list(range(csr.shape[0]))
    np.testing.assert_array_equal(got, jperm.jaccard_rows_fast(
        csr, block_w=16, tau=tau, max_candidates=max_candidates))


def test_packed_patterns_and_empty_rows_equal():
    dense = np.zeros((40, 64), np.float32)
    dense[::7, :8] = 1.0          # a few populated rows, many empty
    csr = sp.csr_matrix(dense)
    for x, y in zip(tperm.pack_block_patterns(csr, 16),
                    jperm.pack_block_patterns(csr, 16)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        tperm.jaccard_rows_fast(csr, block_w=16, tau=0.7),
        jperm.jaccard_rows_fast(csr, block_w=16, tau=0.7))


# ------------------------------------------------------- shard-balance helpers
@pytest.mark.parametrize("bpr,n_shards,kw", [
    ([5, 1, 3, 3, 9, 0, 2, 4], 3, {}),
    ([5, 1, 3, 3, 9, 0, 2, 4], 4, dict(rows_per_shard=2)),
    ([2, 2, 2, 2, 2, 2], 2, dict(max_load=6)),
    (list(range(17)), 5, {}),
])
def test_shard_bins_equal(bpr, n_shards, kw):
    np.testing.assert_array_equal(tperm.shard_bins(np.array(bpr), n_shards,
                                                   **kw),
                                  jperm.shard_bins(np.array(bpr), n_shards,
                                                   **kw))


def test_shard_bins_and_split_heavy_rows_raise_alike():
    for mod in (tperm, jperm):
        with pytest.raises(ValueError, match="cannot fit"):
            mod.shard_bins(np.array([9, 1]), 2, max_load=5)
        with pytest.raises(ValueError, match="n_shards"):
            mod.shard_bins(np.array([1]), 0)
        with pytest.raises(ValueError, match="max_load"):
            mod.split_heavy_rows(np.array([1]), 0)


@pytest.mark.parametrize("bpr,max_load", [([2, 7, 1], 3), ([10, 0, 4], 4),
                                          ([1, 1, 1], 5)])
def test_split_heavy_rows_equal(bpr, max_load):
    for x, y in zip(tperm.split_heavy_rows(np.array(bpr), max_load),
                    jperm.split_heavy_rows(np.array(bpr), max_load)):
        np.testing.assert_array_equal(x, y)


def test_shard_balance_rows_equal():
    csr = jtopo.blocked_random(n=500, nnz_target=5_000, cluster=20, seed=6)
    np.testing.assert_array_equal(
        tperm.shard_balance_rows(csr, (16, 16), n_shards=4),
        jperm.shard_balance_rows(csr, (16, 16), n_shards=4))


# ------------------------------------------------------- prepare(reorder=...)
@pytest.mark.parametrize("granularity", ["element", "block_row"])
@pytest.mark.parametrize("scheme", ROW_SCHEMES)
@pytest.mark.parametrize("name,make", OPERANDS, ids=[n for n, _ in OPERANDS])
def test_prepare_with_reorder_equal(name, make, scheme, granularity):
    ja, ta = make()
    kw = dict(reorder=scheme, reorder_granularity=granularity, tau=0.6,
              max_candidates=128, n_shards=4)
    j_arrays, j_meta = jops.prepare(ja, dtype=jnp.float32, **kw)
    t_arrays, t_meta = tops.prepare(ta, torch.float32, device="cpu", **kw)
    for field in jops.SparseArrays._fields:
        want = np.asarray(getattr(j_arrays, field))
        got = getattr(t_arrays, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert dataclasses.asdict(t_meta) == dataclasses.asdict(j_meta)
    assert tops.prepare(ta, meta_only=True, **kw) == t_meta
    assert dataclasses.asdict(jops.prepare(ja, meta_only=True, **kw)) == \
        dataclasses.asdict(t_meta)
