"""The port's host BCSR module against the JAX package's: the same numpy
inputs and seeds give EXACTLY equal arrays (host data has no tolerance)."""
import numpy as np
import pytest

from repro.core import bcsr as jb
from repro_torch.core import bcsr as tb
from repro_torch.core import permute as tperm


def _assert_same(a, b):
    for field in ("vals", "col_ids", "row_ids", "rowptr"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert tuple(a.shape) == tuple(b.shape)
    assert tuple(a.block) == tuple(b.block)


EXACT = [((64, 64), (8, 8), 16), ((128, 256), (16, 32), 40),
         ((256, 128), (32, 16), 60), ((96, 160), (16, 16), 30),
         ((8192, 2048), (128, 128), 112)]


@pytest.mark.parametrize("shape,block,nnzb", EXACT)
def test_random_bcsr_exact_equal(shape, block, nnzb):
    _assert_same(jb.random_bcsr_exact(7, shape, block, nnzb),
                 tb.random_bcsr_exact(7, shape, block, nnzb))


@pytest.mark.parametrize("shape,block,density,fill", [
    ((64, 64), (8, 8), 0.5, 1.0), ((128, 256), (16, 32), 0.3, 0.6),
    ((256, 128), (32, 16), 0.15, 1.0), ((96, 160), (16, 16), 0.05, 1.0)])
def test_random_bcsr_equal(shape, block, density, fill):
    _assert_same(jb.random_bcsr(3, shape, block, density, fill_density=fill),
                 tb.random_bcsr(3, shape, block, density, fill_density=fill))


def _ragged_dense():
    """50x70 with empty block-rows and block-cols at (16, 16) blocks."""
    dense = np.random.default_rng(9).standard_normal((50, 70)).astype(
        np.float32)
    dense[np.abs(dense) < 1.0] = 0
    dense[16:32] = 0                     # an empty block-row
    dense[:, 32:48] = 0                  # an empty block-col
    return dense


def test_from_dense_equal():
    dense = _ragged_dense()
    _assert_same(jb.from_dense(dense, (16, 16)), tb.from_dense(dense, (16, 16)))
    np.testing.assert_array_equal(tb.from_dense(dense, (16, 16)).to_dense(),
                                  dense)


@pytest.mark.parametrize("return_mask", [False, True])
def test_ensure_nonempty_rows_equal(return_mask):
    dense = _ragged_dense()
    ja = jb.from_dense(dense, (16, 16)).ensure_nonempty_rows(return_mask)
    ta = tb.from_dense(dense, (16, 16)).ensure_nonempty_rows(return_mask)
    if return_mask:
        (ja, jm), (ta, tm) = ja, ta
        np.testing.assert_array_equal(jm, tm)
        assert not tm.all()              # the padded row is tagged
    _assert_same(ja, ta)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dispatch_stats_and_blocks_per_row_equal(seed):
    ja = jb.random_bcsr(seed, (256, 192), (16, 16), 0.2, fill_density=0.7)
    ta = tb.random_bcsr(seed, (256, 192), (16, 16), 0.2, fill_density=0.7)
    assert ja.dispatch_stats() == ta.dispatch_stats()
    np.testing.assert_array_equal(ja.blocks_per_row(), ta.blocks_per_row())
    assert (ja.nnzb, ja.nnz, ja.padding_ratio) == \
        (ta.nnzb, ta.nnz, ta.padding_ratio)


@pytest.mark.parametrize("shape,block,nnzb", EXACT[:4])
def test_transpose_equal(shape, block, nnzb):
    ja = jb.random_bcsr_exact(11, shape, block, nnzb)
    ta = tb.random_bcsr_exact(11, shape, block, nnzb)
    _assert_same(ja.transpose(), ta.transpose())
    np.testing.assert_array_equal(ta.transpose().to_dense(), ta.to_dense().T)


def test_rowptr_from_rows_equal():
    rows = np.array([0, 0, 2, 2, 2, 5], np.int32)
    np.testing.assert_array_equal(jb.rowptr_from_rows(rows, 7),
                                  tb.rowptr_from_rows(rows, 7))


def test_identity_permutation_only():
    a = tb.random_bcsr_exact(0, (64, 64), (8, 8), 16)
    same, perm = tperm.permute_bcsr(a, "identity")
    assert same is a
    np.testing.assert_array_equal(perm, np.arange(64))
    np.testing.assert_array_equal(tperm.invert_perm(perm[::-1].copy()),
                                  np.arange(64)[::-1])
    with pytest.raises(NotImplementedError, match="not ported"):
        tperm.permute_bcsr(a, "jaccard")
