"""The port's partitioned SpMM (``repro_torch.launch.dist_spmm``) against the
JAX package's ``repro.launch.dist_spmm``.

* Host data: ``prepare_sharded``'s every index tensor, ``gather_rows``,
  ``split_src``/``split_dst`` and the ``ShardedMeta`` (each per-shard meta)
  exactly equal to JAX's ``_prepare_sharded_host`` over a structure zoo;
  the inputs JAX refuses, the port refuses too.
* ``chunk_schedule``, ``shard_balance_stats`` exactly equal; the shard-count
  pick equal where both tuners see the same decision (one device, or the
  same measured entry: the analytic models differ by design, the port's is
  the H100's), under keys that are JAX's plus ``|dev=``.
* ``spmm_sharded`` in-process against the JAX ``spmm_sharded`` (unlocked by
  the ``jax_oracle`` fixture, ROADMAP C1): forward and the gradients of
  ``vals`` and B within 1e-5 (rtol and atol) in f32, for S in {1, 2, 4, 8},
  ``n_chunks`` in {1, 2, 3} and every port backend, against the JAX
  ``xla`` backend at the same S and chunk depth (the partition's math);
  and at S = 2 against the JAX backend whose Pallas kernel each port
  kernel replaces, in interpret mode.
* Inside the port: chunked == unchunked, bit for bit, forward and both
  gradients, for chunks of two or more columns (a one-column chunk runs a
  matrix-vector product on the CPU, summed in another order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcsr as jb
from repro.core import topology as jtopo
from repro.kernels import autotune as jat
from repro.launch import dist_spmm as jd
from repro.obs import jaxmon
from repro_torch.core import bcsr as tb
from repro_torch.core import topology as ttopo
from repro_torch.kernels import autotune as tat
from repro_torch.launch import dist_spmm as td

SHARD_COUNTS = (1, 2, 4, 8)
N = 24
# port backend -> the JAX backend whose kernel it replaces
JAX_BACKEND = {"nnz_stream": "pallas", "row_loop": "row_loop", "xla": "xla",
               "auto": "auto"}


@pytest.fixture
def jax_oracle(monkeypatch):
    """Unlock the monitored JAX functions (ROADMAP C1), test-side only."""
    monkeypatch.setattr(jaxmon, "_trace_active",
                        lambda: not jax._src.core.trace_state_clean())


def _pair(name):
    """(jax BCSR, port BCSR) of one structure of the zoo."""
    if name == "uniform":
        return (jb.random_bcsr_exact(7, (320, 256), (16, 16), nnzb=80),
                tb.random_bcsr_exact(7, (320, 256), (16, 16), nnzb=80))
    if name == "ragged":          # partial trailing block-row
        return (jb.random_bcsr(0, (23 * 16 + 5, 160), (16, 16), 0.3),
                tb.random_bcsr(0, (23 * 16 + 5, 160), (16, 16), 0.3))
    if name == "skewed":          # power-law rows, empty element rows
        return (jb.from_scipy(jtopo.power_law(500, 5.0, seed=2), (16, 16)),
                tb.from_scipy(ttopo.power_law(500, 5.0, seed=2), (16, 16)))
    if name == "empty_rows":      # whole block-rows with no block
        return (jb.random_bcsr(4, (256, 128), (16, 16), 0.08),
                tb.random_bcsr(4, (256, 128), (16, 16), 0.08))
    if name == "few_rows":        # 3 block-rows: more shards than rows
        return (jb.random_bcsr_exact(1, (48, 64), (16, 16), nnzb=6),
                tb.random_bcsr_exact(1, (48, 64), (16, 16), nnzb=6))
    if name == "heavy":           # one dominant block-row: 32 of 47 blocks
        dense = np.zeros((16 * 16, 32 * 16), np.float32)
        dense[::16, 0] = 1.0
        dense[16:32] = np.random.default_rng(3).standard_normal((16, 512))
        return jb.from_dense(dense, (16, 16)), tb.from_dense(dense, (16, 16))
    raise KeyError(name)


# (structure, n_shards, keywords)
ZOO = [(s, n, {}) for s in ("uniform", "ragged", "skewed", "empty_rows")
       for n in SHARD_COUNTS]
ZOO += [("few_rows", 8, {}), ("few_rows", 4, {}),
        ("ragged", 4, {"reorder": "jaccard"}), ("skewed", 2, {"reorder": "rcm"}),
        ("ragged", 4, {"reorder": "shard_balance"}),
        ("heavy", 4, {"split_heavy_rows": True}),
        ("heavy", 2, {"split_heavy_rows": True}),
        ("skewed", 8, {"split_heavy_rows": True}),
        ("uniform", 4, {"rows_per_shard": 6, "nnzb_per_shard": 30}),
        ("ragged", 2, {"col_shards": 2}),
        ("uniform", 8, {"rows_per_shard": 3})]
RAISES = [("heavy", 4, {}),                                  # heavy row
          ("uniform", 4, {"nnzb_per_shard": 10}),            # budget too small
          ("uniform", 4, {"rows_per_shard": 2}),             # slots too few
          ("heavy", 4, {"split_heavy_rows": True, "nnzb_per_shard": 40}),
          ("uniform", 0, {}), ("uniform", "many", {})]


def _ids(cases):
    return [f"{s}-S{n}-" + "-".join(f"{k}={v}" for k, v in kw.items())
            for s, n, kw in cases]


@pytest.mark.parametrize("structure,n_shards,kw", ZOO, ids=_ids(ZOO))
def test_host_data_equal_jax(structure, n_shards, kw):
    ja, ta = _pair(structure)
    j_host, j_meta = jd._prepare_sharded_host(ja, n_shards, **kw)
    t_host, t_meta = td._prepare_sharded_host(ta, n_shards, device="cpu",
                                              **kw)
    assert set(t_host) == set(j_host)
    for name, value in j_host.items():
        np.testing.assert_array_equal(t_host[name], np.asarray(value),
                                      err_msg=name)
        assert t_host[name].dtype == np.asarray(value).dtype, name
    assert dataclasses.asdict(t_meta) == dataclasses.asdict(j_meta)
    # the tensors prepare_sharded builds hold that data, plus per-shard
    # port fields over each shard's own entry list
    arrays, meta = td.prepare_sharded(ta, n_shards, dtype=torch.float32,
                                      device="cpu", **kw)
    assert meta == t_meta
    for name in td.ShardedArrays._fields[:11]:
        np.testing.assert_array_equal(getattr(arrays, name).numpy(),
                                      np.asarray(j_host[name]), err_msg=name)
    assert td.prepare_sharded_meta(ta, n_shards, **kw) == t_meta
    assert td.prepare(ta, n_shards, meta_only=True, **kw) == t_meta
    rowptr = arrays.rowptr.numpy()
    for s in range(meta.n_shards):
        counts = np.bincount(j_host["row_ids"][s],
                             minlength=meta.rows_per_shard)
        np.testing.assert_array_equal(np.diff(rowptr[s]), counts)


@pytest.mark.parametrize("structure,n_shards,kw", RAISES, ids=_ids(RAISES))
def test_refused_inputs_raise_in_both(structure, n_shards, kw):
    ja, ta = _pair(structure)
    with pytest.raises(ValueError) as j_err:
        jd._prepare_sharded_host(ja, n_shards, **kw)
    with pytest.raises(ValueError) as t_err:
        td._prepare_sharded_host(ta, n_shards, device="cpu", **kw)
    assert str(t_err.value) == str(j_err.value)


def test_chunk_schedule_and_balance_stats_equal_jax():
    for n in (1, 2, 3, 4, 10, 17, 2048):
        for k in (1, 2, 3, 4, 7, 64):
            assert td.chunk_schedule(n, k) == jd.chunk_schedule(n, k)
    for bad in ((0, 2), (4, 0)):
        with pytest.raises(ValueError):
            jd.chunk_schedule(*bad)
        with pytest.raises(ValueError):
            td.chunk_schedule(*bad)
    for structure in ("uniform", "ragged", "skewed", "heavy"):
        ja, ta = _pair(structure)
        for s in SHARD_COUNTS:
            assert td.shard_balance_stats(ta, s) == \
                jd.shard_balance_stats(ja, s)
        assert td.shard_balance_stats(ta, 4, rows_per_shard=9) == \
            jd.shard_balance_stats(ja, 4, rows_per_shard=9)


def test_resolve_n_shards_equal_jax_and_keyed_by_device(monkeypatch):
    """One device (``max_shards=1``) resolves S = 1 in both; with the same
    measured entry in both tuners both return it; the entry's key is the
    JAX package's plus ``|dev=``.  (The analytic picks at ``max_shards >
    1`` come from each package's own device model.)  JAX's
    ``resolve_n_shards`` reads ``tuner or get_autotuner()``, so an empty
    tuner passed to it is replaced by the global one (ROADMAP C2): its
    tuner is installed as the global one here."""
    for structure in ("uniform", "ragged", "skewed"):
        ja, ta = _pair(structure)
        for n in (4, 512):
            j = jd.resolve_n_shards(ja, n=n, max_shards=1,
                                    tuner=jat.Autotuner())
            t = td.resolve_n_shards(ta, n=n, max_shards=1,
                                    tuner=tat.Autotuner(), device="cpu")
            assert (t.n_shards, t.source) == (j.n_shards, j.source) == \
                (1, "analytic")
        jt, tt = jat.Autotuner(), tat.Autotuner()
        j_fp = jat.fingerprint(jd.ops.prepare_sparse_meta(ja), 512,
                               n_chunks=2)
        t_fp = tat.fingerprint(td.ops.prepare_sparse_meta(ta), 512,
                               n_chunks=2, device="cpu")
        assert tat.shard_entry_key(t_fp, 8) == \
            jat.shard_entry_key(j_fp, 8) + "|dev=cpu"
        monkeypatch.setattr(jat, "_DEFAULT_TUNER", jt)
        monkeypatch.setattr(tat, "_DEFAULT_TUNER", tt)
        jt.put_shards(j_fp, 8, jat.ShardChoice(4, source="measured"),
                      persist=False)
        tt.put_shards(t_fp, 8, tat.ShardChoice(4, source="measured"),
                      persist=False)
        j = jd.resolve_n_shards(ja, max_shards=8, tuner=jt)
        t = td.resolve_n_shards(ta, max_shards=8, tuner=tt, device="cpu")
        assert (t.n_shards, t.source) == (j.n_shards, j.source) == \
            (4, "measured")
        # "auto" through prepare resolves the same count
        assert td._prepare_sharded_host(ta, "auto", device="cpu")[1] \
            .n_shards == jd._prepare_sharded_host(ja, "auto")[1].n_shards


def test_tune_keys_are_jax_keys_plus_device():
    ja, ta = _pair("ragged")
    arrays, smeta = td.prepare_sharded(ta, 4, dtype=torch.float32,
                                       device="cpu")
    _, j_meta = jd._prepare_sharded_host(ja, 4)
    tuner = tat.Autotuner()
    tuned = td.tune_shards(arrays, smeta, 16, iters=1, tuner=tuner)
    want = {jat.fingerprint(m, 16).key() + "|dev=cpu"
            for m in j_meta.shard_metas}
    assert set(tuned) == want
    assert all(tat.get_variant(c.variant).is_kernel and
               c.source == "measured" for c in tuned.values())
    choice = td.tune_shard_count(ta, 16, max_shards=4, n_chunks=2, iters=1,
                                 tuner=tuner, device="cpu")
    assert choice.source == "measured" and choice.n_shards in (1, 2, 4)
    j_fp = jat.fingerprint(jd.ops.prepare_sparse_meta(ja), 16, n_chunks=2)
    key = jat.shard_entry_key(j_fp, 4) + "|dev=cpu"
    assert tuner._shards[key] == choice
    t_fp = tat.fingerprint(td.ops.prepare_sparse_meta(ta), 16, n_chunks=2,
                           device="cpu")
    assert td.resolve_n_shards(ta, n=16, max_shards=4, n_chunks=2,
                               tuner=tuner, device="cpu") == choice
    assert tuner.get_shards(t_fp, 4) == choice


# ----------------------------------------------------------------- numerics
def _weight(shape):
    return np.sin(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)


@functools.lru_cache(maxsize=None)
def _jax_result(n_shards, backend, n_chunks):
    """(out, dvals, dB) of the JAX sharded product, float32, numpy."""
    ja, _ = _pair("ragged")
    arrays, smeta = jd.prepare_sharded(ja, n_shards, dtype=jnp.float32)
    b = jnp.asarray(np.random.default_rng(1).standard_normal(
        (ja.shape[1], N)).astype(np.float32))
    weight = jnp.asarray(_weight((ja.shape[0], N)))

    def fwd(v, bb):
        return jd.spmm_sharded(arrays._replace(vals=v), smeta, bb,
                               backend=backend, bn=128, interpret=True,
                               n_chunks=n_chunks)
    out = fwd(arrays.vals, b)
    dv, db = jax.grad(lambda v, bb: jnp.sum(fwd(v, bb) * weight),
                      argnums=(0, 1))(arrays.vals, b)
    return tuple(np.asarray(x) for x in (out, dv, db))


def _port_result(n_shards, backend, n_chunks):
    _, ta = _pair("ragged")
    arrays, smeta = td.prepare_sharded(ta, n_shards, dtype=torch.float32,
                                       device="cpu")
    vals = arrays.vals.clone().requires_grad_()
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (ta.shape[1], N)).astype(np.float32)).requires_grad_()
    out = td.spmm_sharded(arrays._replace(vals=vals), smeta, b,
                          backend=backend, n_chunks=n_chunks)
    (out * torch.from_numpy(_weight(tuple(out.shape)))).sum().backward()
    return out.detach(), vals.grad, b.grad


def _close(got, want):
    for name, g, w in zip(("out", "dvals", "dB"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("n_chunks", (1, 2, 3))
@pytest.mark.parametrize("backend", list(JAX_BACKEND))
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_spmm_sharded_matches_jax(jax_oracle, n_shards, backend, n_chunks):
    _close(_port_result(n_shards, backend, n_chunks),
           _jax_result(n_shards, "xla", n_chunks))


@pytest.mark.parametrize("backend", list(JAX_BACKEND))
def test_spmm_sharded_matches_jax_kernels(jax_oracle, backend):
    _close(_port_result(2, backend, 2),
           _jax_result(2, JAX_BACKEND[backend], 1))


@pytest.mark.parametrize("backend", list(JAX_BACKEND))
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_chunked_equals_unchunked_bitwise(n_shards, backend):
    base = _port_result(n_shards, backend, 1)
    for n_chunks in (2, 3, 5, N // 2):
        got = _port_result(n_shards, backend, n_chunks)
        for name, g, w in zip(("out", "dvals", "dB"), got, base):
            assert torch.equal(g, w), (n_chunks, name)


@pytest.mark.parametrize("n_shards", (2, 4))
def test_split_rows_match_jax_and_are_stable(jax_oracle, n_shards):
    """A block-row split in fragments: the partial sums add back in
    ascending fragment order; the port matches JAX within 1e-5 and itself
    bit for bit."""
    ja, ta = _pair("heavy")
    j_arr, j_meta = jd.prepare_sharded(ja, n_shards, dtype=jnp.float32,
                                       split_heavy_rows=True)
    t_arr, t_meta = td.prepare_sharded(ta, n_shards, dtype=torch.float32,
                                       split_heavy_rows=True, device="cpu")
    assert t_meta.n_split_fragments > 0
    rng = np.random.default_rng(2)
    b = rng.standard_normal((ta.shape[1], 8)).astype(np.float32)
    want = jd.spmm_sharded(j_arr, j_meta, jnp.asarray(b), backend="xla",
                           n_chunks=2)
    got = td.spmm_sharded(t_arr, t_meta, torch.from_numpy(b),
                          backend="nnz_stream", n_chunks=2)
    again = td.spmm_sharded(t_arr, t_meta, torch.from_numpy(b),
                            backend="nnz_stream", n_chunks=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, again)


def test_dispatch_events_and_gauges_equal_jax(jax_oracle):
    """The ``dist.shard_balance`` and ``dist.chunk_schedule`` events and
    the ``dist.shard_imbalance`` / ``dist.n_chunks`` gauges carry JAX's
    payloads."""
    from repro.obs import metrics as jmetrics
    from repro.obs import trace as jtrace
    from repro_torch.obs import metrics as tmetrics
    from repro_torch.obs import trace as ttrace
    ja, ta = _pair("ragged")
    payloads = []
    for trace, metrics, prep, run, arr_dt in (
            (jtrace, jmetrics, jd.prepare_sharded, jd.spmm_sharded,
             jnp.float32),
            (ttrace, tmetrics, functools.partial(td.prepare_sharded,
                                                 device="cpu"),
             td.spmm_sharded, torch.float32)):
        metrics.reset()
        with trace.capture() as cap:
            a = ja if trace is jtrace else ta
            arrays, smeta = prep(a, 4, dtype=arr_dt)
            b = np.ones((a.shape[1], 10), np.float32)
            b = jnp.asarray(b) if trace is jtrace else torch.from_numpy(b)
            run(arrays, smeta, b, backend="xla", n_chunks=3)
        events = [(e.name, {k: (list(v) if isinstance(v, (tuple, list,
                                                          np.ndarray))
                                else v) for k, v in e.args.items()})
                  for e in cap.events if e.name.startswith("dist.")]
        gauges = {k: v for k, v in metrics.snapshot()["gauges"].items()
                  if k.startswith("dist.")}
        payloads.append((events, gauges))
    assert payloads[1] == payloads[0]
    assert [name for name, _ in payloads[0][0]] == [
        "dist.shard_balance", "dist.chunk_schedule"]


def test_docstring_examples():
    import doctest
    res = doctest.testmod(td)
    assert res.attempted > 0 and res.failed == 0, res
