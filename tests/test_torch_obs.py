"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``: the twins of ``tests/test_obs.py`` (deterministic
payloads, exporters, metrics, ``timeit``, the sentinel, the engine's and the
paged decode's static-shape gates, the zero-cost disabled path) and pins
across the packages:

* one prepare + ``backend="auto"`` spmm pass gives the JAX package's
  deterministic payloads.  Two differences are stated and nothing else may
  differ: the autotuner's key carries the port's ``|dev=<device>`` suffix,
  and ``bn`` is each package's own N-tile vocabulary (the port's kernels
  compile 8-64, the TPU kernels' tiles are 128-1024).  The analytic picks
  differ by design (the port's model is the H100's and dispatches only
  kernels; ``test_torch_autotune.py``), so both tuners are given the same
  measured ``row_loop`` decision, whose backend name both packages share;
* the scheduler's ``serve.*`` events equal JAX's record for record;
* a JSONL written by either package reads back through the other."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import bcsr as jbcsr
from repro.kernels import autotune as jat
from repro.kernels import ops as jops
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.serve import scheduler as jsched
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core import bcsr as tbcsr
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import bcsr_spmm as pk
from repro_torch.models import transformer as T
from repro_torch.obs import export, metrics, shapemon, summary, trace
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import loop

SMOKE = "smat-attn-1.3b:smoke"


def _row_loop_choice(module, bn):
    return module.KernelChoice("row_loop", bn, source="measured")


def _spmm_pass_port(seed_tuner=True):
    """One prepare + ``auto`` dispatch pass under a fresh tuner, returning
    the captured events (the JAX test's ``_instrumented_spmm_run``)."""
    tuner = autotune.Autotuner()
    autotune.set_autotuner(tuner)
    a = tbcsr.random_bcsr(0, (128, 64), (16, 16), 0.3)
    try:
        with trace.capture() as cap:
            arrays, meta = ops.prepare(a, torch.float32, reorder="jaccard",
                                       device="cpu")
            if seed_tuner:
                tuner.put(autotune.fingerprint(meta, 32, device="cpu"),
                          _row_loop_choice(autotune, pk.SPMM_TILES[-1]),
                          persist=False)
            b = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (64, 32)).astype(np.float32))
            ops.spmm(arrays, meta, b, backend="auto")
    finally:
        autotune.set_autotuner(None)
    return cap.events


def _spmm_pass_jax():
    tuner = jat.Autotuner()
    jat.set_autotuner(tuner)
    a = jbcsr.random_bcsr(0, (128, 64), (16, 16), 0.3)
    try:
        with jtrace.capture() as cap:
            arrays, meta = jops.prepare_sparse(a, dtype=jnp.float32,
                                               reorder="jaccard")
            tuner.put(jat.fingerprint(meta, 32),
                      _row_loop_choice(jat, 128), persist=False)
            b = jnp.asarray(np.random.default_rng(1).standard_normal(
                (64, 32)), jnp.float32)
            jops.spmm(arrays, meta, b, backend="auto", interpret=True)
    finally:
        jat.set_autotuner(None)
    return cap.events


# ------------------------------------------------------------ determinism
@pytest.mark.parametrize("seeded", [True, False])
def test_deterministic_payloads_bitwise_stable_across_runs(seeded):
    p1, p2 = (export.deterministic_events(_spmm_pass_port(seeded))
              for _ in range(2))
    assert p1 and p1 == p2
    assert export.checksum(p1) == export.checksum(p2)
    assert {"prepare.reorder", "prepare.meta", "prepare.done",
            "autotune.pick", "ops.dispatch"} <= {p["name"] for p in p1}


def test_prepare_and_dispatch_payloads_equal_jax():
    """The stated differences (module docstring) and nothing else."""
    got = export.deterministic_events(_spmm_pass_port())
    want = jexport.deterministic_events(_spmm_pass_jax())
    assert [p["name"] for p in got] == [p["name"] for p in want] == [
        "prepare.reorder", "prepare.reorder", "prepare.meta", "prepare.meta",
        "prepare.done", "autotune.pick", "ops.dispatch"]
    for g, w in zip(got, want):
        g, w = json.loads(json.dumps(g)), json.loads(json.dumps(w))
        if g["name"] == "autotune.pick":
            assert g["args"]["key"] == w["args"]["key"] + "|dev=cpu"
            assert g["args"].pop("key") and w["args"].pop("key")
        if g["name"] in ("autotune.pick", "ops.dispatch"):
            assert (g["args"].pop("bn"), w["args"].pop("bn")) == \
                (pk.SPMM_TILES[-1], 128)
        assert g == w


def test_span_nesting_and_args_are_jsonified():
    with trace.capture() as cap:
        with trace.span("outer", n=np.int64(3), t=torch.tensor(2)):
            with trace.span("inner"):
                trace.event("leaf", xs=(1, 2), arr=np.arange(2),
                            ten=torch.arange(3), shape=torch.Size([4, 5]))
    kinds = [(e.kind, e.name) for e in cap.events]
    assert kinds == [("B", "outer"), ("B", "inner"), ("I", "leaf"),
                     ("E", "inner"), ("E", "outer")]
    outer_b, inner_b, leaf = cap.events[:3]
    assert inner_b.parent == outer_b.span
    assert leaf.parent == inner_b.span and leaf.span is None
    assert outer_b.args == {"n": 3, "t": 2}
    assert leaf.args == {"xs": [1, 2], "arr": [0, 1], "ten": [0, 1, 2],
                         "shape": [4, 5]}


# -------------------------------------------------------------- exporters
def test_jsonl_round_trip(tmp_path):
    path = os.path.join(tmp_path, "trace.jsonl")
    with trace.capture(path=path) as cap:
        with trace.span("work", k=1):
            trace.event("mark", v="x")
    read = export.read_jsonl(path)
    assert [e.to_dict() for e in read] == [e.to_dict() for e in cap.events]
    with open(path) as f:
        assert len([json.loads(ln) for ln in f]) == len(cap.events)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_jsonl_reads_back_across_packages(tmp_path, writer):
    path = os.path.join(tmp_path, f"{writer}.jsonl")
    tr, reader = (trace, jexport) if writer == "port" else (jtrace, export)
    with tr.capture(path=path) as cap:
        with tr.span("serve.step", step=0):
            tr.event("serve.admit", rid=1, slot=0)
        tr.timed_event("train.step", 12.5, step=0, loss=1.25)
    read = reader.read_jsonl(path)
    assert [e.to_dict() for e in read] == [e.to_dict() for e in cap.events]


def test_perfetto_export_is_valid(tmp_path):
    with trace.capture() as cap:
        with trace.span("a"):
            trace.event("i1")
        with trace.span("b"):
            pass
    doc = export.to_perfetto(cap.events)
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    phases = [te["ph"] for te in doc["traceEvents"]]
    assert phases.count("B") == phases.count("E") == 2
    assert phases.count("i") == 1
    for te in doc["traceEvents"]:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(te)
    out = os.path.join(tmp_path, "p.json")
    export.write_perfetto(cap.events, out)
    assert json.load(open(out)) == doc


def test_summary_tree_renders_span_hierarchy():
    with trace.capture() as cap:
        for _ in range(2):
            with trace.span("phase"):
                with trace.span("sub"):
                    pass
                trace.event("tick")
    text = export.summary_tree(cap.events)
    assert "phase x2" in text and "sub x2" in text
    assert "[event] tick x2" in text


def test_summary_cli(tmp_path, capsys):
    path = os.path.join(tmp_path, "t.jsonl")
    with trace.capture(path=path):
        with trace.span("serve.step", step=0):
            trace.event("serve.admit", rid=0)
    out = os.path.join(tmp_path, "pf.json")
    assert summary.main([path, "--perfetto", out]) == 0
    text = capsys.readouterr().out
    assert "serve.step x1" in text and "[event] serve.admit x1" in text
    assert len(json.load(open(out))["traceEvents"]) == 3


# ---------------------------------------------------------------- metrics
def test_metrics_labels_snapshot_reset():
    r = metrics.Registry()
    r.counter("hits", op="spmm").inc()
    r.counter("hits", op="spmm").inc(2)
    r.counter("hits", op="sddmm").inc()
    r.gauge("level").set(0.25)
    h = r.histogram("lat")
    for v in (0.5, 3, 10_000):
        h.observe(v)
    snap = r.snapshot()
    assert snap["counters"] == {"hits{op=sddmm}": 1, "hits{op=spmm}": 3}
    assert snap["gauges"] == {"level": 0.25}
    hs = snap["histograms"]["lat"]
    assert hs["count"] == 3 and hs["min"] == 0.5 and hs["max"] == 10_000
    assert hs["buckets"]["le_1"] == 1 and hs["buckets"]["inf"] == 1
    r.reset()
    assert r.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_metrics_type_conflict_raises():
    r = metrics.Registry()
    r.counter("x")
    with pytest.raises(TypeError):
        r.gauge("x")


def test_timeit_reduce_modes_and_validation():
    calls = []
    sec = metrics.timeit(lambda: calls.append(1), warmup=1, iters=3,
                         reduce="min")
    assert len(calls) == 4 and sec >= 0.0
    with pytest.raises(ValueError):
        metrics.timeit(lambda: None, reduce="mean")


def test_timeit_synchronises_only_for_cuda_results(monkeypatch):
    """A result holding a CUDA tensor (here a stand-in with a CUDA device)
    is waited for with ``torch.cuda.synchronize()`` after every call; a
    CPU result is not."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(1))

    class OnCard:
        device = torch.device("cuda")
    metrics.timeit(lambda: torch.ones(2), warmup=1, iters=2)
    assert syncs == []
    metrics.timeit(lambda: {"out": [OnCard()]}, warmup=1, iters=2,
                   name="obs_test.card")
    assert len(syncs) == 3
    assert metrics.snapshot()["histograms"]["bench.obs_test.card"][
        "count"] == 1


# ------------------------------------------------------- signature sentinel
def test_sentinel_counts_signatures_not_calls():
    @shapemon.monitor
    def poly(x, pos, cache=None):
        return x * pos

    poly(torch.ones(2), 1)
    poly(torch.ones(2), 7)                  # pos's value does not count
    assert shapemon.trace_count(poly) == 1
    shapemon.assert_max_traces(poly, 1)
    poly(torch.ones(3), 1)                  # new shape
    poly(torch.ones(2, dtype=torch.float64), 1)      # new dtype
    poly(torch.ones(2), 1.5)                # pos of another type
    poly(torch.ones(2), 1, cache={"k": torch.ones(2)})   # a nested dict
    poly(torch.ones(2), 1, cache={"k": torch.zeros(2)})  # its values do not
    assert shapemon.trace_count(poly) == 5
    with pytest.raises(shapemon.RetraceError):
        shapemon.assert_max_traces(poly, 4)
    with trace.capture() as cap:
        poly(torch.ones(5), 1)
        poly(torch.ones(5), 2)
    assert [(e.name, e.args) for e in cap.events] == [
        ("torch.signature", {"fn": poly.sentinel.name, "n": 6})]
    shapemon.reset(poly)
    assert shapemon.trace_count(poly) == 0
    poly(torch.ones(2), 1)
    assert shapemon.trace_count(poly) == 1


def test_sentinel_registry_lookup_by_name():
    @shapemon.monitor(name="obs_test.named")
    def g(x):
        return x + 1

    g(torch.zeros(2))
    assert shapemon.trace_count("obs_test.named") == 1
    assert shapemon.sentinels()["obs_test.named"] == 1
    with pytest.raises(KeyError, match="no signature sentinel"):
        shapemon.trace_count("obs_test.missing")
    with pytest.raises(TypeError):
        shapemon.trace_count(3)


# ----------------------------------------------------- static-shape gates
def _attn_cfg(paged):
    cfg = get_config(SMOKE)
    return dataclasses.replace(cfg, dtype="float32", attn_sparsity=(
        dataclasses.replace(cfg.attn_sparsity, paged_decode=paged)))


def _requests(n=5, max_new=3):
    rng = np.random.default_rng(0)
    lens = (3, 7, 5, 2, 6)
    return [Request(rid=i, prompt=rng.integers(0, 97, size=lens[i % 5],
                                               dtype=np.int32),
                    max_new_tokens=max_new) for i in range(n)]


@pytest.fixture(scope="module")
def attn_model():
    return T.init_params(_attn_cfg("auto"), seed=0, device="cpu")


def test_serve_engine_sees_one_signature(attn_model):
    """Mixed prompt lengths, admissions and evictions over 2 slots: the
    decode call ``serve.masked_step`` sees ONE input signature."""
    eng = ServeEngine(_attn_cfg("auto"), attn_model, n_slots=2,
                      cache_len=64, device="cpu")
    list(eng.generate(_requests()))
    assert eng.decode_calls > 10
    assert eng.step_sentinel.count == 1
    shapemon.assert_max_traces(eng.step_sentinel, 1)
    assert shapemon.trace_count("serve.masked_step") == 1


def test_paged_decode_sees_one_signature_per_engine(attn_model):
    shapemon.reset("models.paged_decode")
    eng = ServeEngine(_attn_cfg("auto"), attn_model, n_slots=2,
                      cache_len=64, device="cpu")
    assert eng.paged_kv is not None
    assert eng.paged_kv.report()["groups"][0]["paged"]
    list(eng.generate(_requests()))
    assert shapemon.trace_count("models.paged_decode") == 1
    shapemon.assert_max_traces("models.paged_decode", 1)


def test_engine_emits_serve_spans_and_counters(attn_model):
    metrics.reset()
    eng = ServeEngine(_attn_cfg("off"), attn_model, n_slots=2, cache_len=64,
                      device="cpu")
    with trace.capture() as cap:
        streams = list(eng.generate(_requests()))
    steps = eng.scheduler.step_idx
    names = [e.name for e in cap.events]
    assert names.count("serve.step") == 2 * steps          # B and E
    assert [e.args["step"] for e in cap.events
            if e.name == "serve.step" and e.kind == "B"] == list(range(steps))
    assert names.count("serve.admit") == names.count("serve.finish") == 5
    snap = metrics.snapshot()
    assert snap["counters"]["serve.steps"] == steps
    assert snap["counters"]["serve.tokens"] == len(streams) == 15
    assert snap["counters"]["serve.admit"] == snap["counters"][
        "serve.finish"] == 5
    assert snap["histograms"]["serve.latency_steps"]["count"] == 5


def _drive(module, tr):
    """A Scheduler to completion over the shared-prefix stream, sampling
    (31 * pos + slot) % 97, under the package's trace capture."""
    class Req:
        def __init__(self, rid, prompt, n):
            self.rid, self.prompt = rid, np.asarray(prompt, np.int32)
            self.max_new_tokens, self.out_tokens = n, []
    s = module.Scheduler(module.SchedulerConfig(n_slots=2, cache_len=16))
    with tr.capture() as cap:
        for rid, prompt, n in [(0, [5, 6, 7, 8], 3), (1, [9, 10], 2),
                               (2, [5, 6, 7, 1, 2], 2), (3, [11], 4),
                               (4, [9, 10, 12], 1)]:
            s.enqueue(Req(rid, prompt, n))
        while s.has_work():
            s.admit()
            for pos, entries in s.plan():
                for slot, token, _ in entries:
                    s.advance(slot, token)
                for slot, _, sample in entries:
                    if sample:
                        s.record_output(slot, (31 * pos + slot) % 97)
            s.step_idx += 1
    return cap.events, s


def test_scheduler_events_and_metrics_equal_jax():
    metrics.reset()
    jmetrics.reset()
    got, ts = _drive(tsched, trace)
    want, js = _drive(jsched, jtrace)
    assert export.deterministic_events(got) == \
        jexport.deterministic_events(want)
    assert [e.args for e in got] == ts.trace == js.trace
    assert ts.prefix_hits > 0
    pick = ("serve.admit", "serve.prefix_hit", "serve.prefix_tokens_reused",
            "serve.finish", "serve.latency_steps")
    port = {k: v for kind in ("counters", "histograms")
            for k, v in metrics.snapshot()[kind].items() if k in pick}
    ref = {k: v for kind in ("counters", "histograms")
           for k, v in jmetrics.snapshot()[kind].items() if k in pick}
    assert port == ref and sorted(port) == sorted(pick)


def test_train_loop_emits_train_events(tmp_path):
    metrics.reset()
    cfg = get_config("smat-ffn-1.3b:smoke")
    with trace.capture() as cap:
        res = loop.train(cfg, ShapeCell("t", "train", 8, 1), device="cpu",
                         total_steps=2)
    steps = [e for e in cap.events if e.name == "train.step"]
    assert [e.args for e in steps] == [{"step": i, "loss": res.losses[i]}
                                       for i in range(2)]
    assert all(e.dur_us is not None and e.dur_us > 0 for e in steps)
    snap = metrics.snapshot()
    assert snap["counters"]["train.steps"] == 2
    assert snap["gauges"]["train.loss"] == res.losses[-1]
    assert snap["histograms"]["train.step_time_us"]["count"] == 2
    # the model's sparse FFN dispatched through ops.resolve_backend
    assert any(e.name == "ops.dispatch" for e in cap.events)


def test_autotune_tune_emits_span_and_event():
    tuner = autotune.Autotuner()
    a = tbcsr.random_bcsr(0, (64, 64), (16, 16), 0.3)
    with trace.capture() as cap:
        choice, timings = tuner.tune(a, 8, iters=1, device="cpu")
        meta = ops.prepare(a, meta_only=True, device="cpu")
        tuner.pick(meta, 8, device="cpu")
    names = [(e.kind, e.name) for e in cap.events]
    assert ("B", "autotune.tune") in names and ("E", "autotune.tune") in names
    tuned = [e for e in cap.events if e.name == "autotune.tuned"]
    assert len(tuned) == 1 and tuned[0].args["variant"] == choice.variant
    assert tuned[0].args["n_candidates"] == len(timings)
    hit = [e for e in cap.events if e.name == "autotune.pick"][-1]
    assert hit.args["cache_hit"] and hit.args["source"] == "measured"
    assert hit.args["key"].endswith("|dev=cpu")


def test_pick_shards_emits_its_event():
    tuner = autotune.Autotuner()
    meta = ops.prepare(tbcsr.random_bcsr(0, (64, 64), (16, 16), 0.3),
                       meta_only=True, device="cpu")
    metrics.reset()
    with trace.capture() as cap:
        first = tuner.pick_shards(meta, 8, device="cpu")
        again = tuner.pick_shards(meta, 8, device="cpu")
    assert first == again
    assert [e.args["cache_hit"] for e in cap.events
            if e.name == "autotune.pick_shards"] == [False, True]
    counters = metrics.snapshot()["counters"]
    assert counters["autotune.cache_miss{kind=shards}"] == 1
    assert counters["autotune.cache_hit{kind=shards}"] == 1


# ------------------------------------------------------- disabled => free
def test_disabled_tracing_is_zero_cost():
    trace.configure(None)
    try:
        assert not trace.enabled()
        s1 = trace.span("x", a=1)
        s2 = trace.span("y")
        assert s1 is s2 is trace._NULL_SPAN
        with s1:
            pass
        assert trace.event("z", k=2) is None
        assert trace.timed_event("w", 1.0) is None
        assert trace.get_events() == []
        assert metrics.timeit(lambda: None, warmup=0, iters=1) >= 0.0
    finally:
        trace.configure(os.environ.get("REPRO_TRACE"))


def test_capture_works_even_when_disabled():
    trace.configure(None)
    try:
        with trace.capture() as cap:
            with trace.span("s"):
                trace.event("e")
        assert [e.name for e in cap.events] == ["s", "e", "s"]
        assert not trace.enabled()
    finally:
        trace.configure(os.environ.get("REPRO_TRACE"))


def test_docstring_examples():
    import doctest
    from repro_torch.obs import export as ex
    from repro_torch.obs import metrics as me
    from repro_torch.obs import trace as tr
    for module in (tr, me, ex, shapemon):
        res = doctest.testmod(module)
        assert res.attempted > 0 and res.failed == 0, (module, res)
