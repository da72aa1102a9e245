"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few
whole steps or batches of prompts after the measured window, reduced to what the
per-layer readers and the result's ``breakdown`` need.

Only the device's activity is recorded (kernels, copies, memsets, and the
host's CUDA runtime and driver calls that CUPTI sees): recording every
host operation as well slowed a training step by half and so inflated the
idle share it is meant to show.  The profiler's Chrome trace is written to
``$TMPDIR``, read back and deleted.  The slice runs from the first CUDA
call to the end of the last event (the closing sync).  From it: the union
of the device operations' intervals (``busy_s``) against the slice's
length (``wall_s``); device time by kernel name; the host's kernel launch
calls (``cudaLaunchKernel`` and its kin); and the longest idle gaps of the
device, each named by the CUDA call the host was in at its middle (or
none) and the device operation that ended it.
"""
from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
N_TOP = 10


def run_traced(units, sync) -> dict:
    """Run ``units`` (callables, one a step or a batch of prompts) under the profiler
    and reduce its trace (``reduce``)."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for unit in units:
            unit()
        sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events) -> dict:
    """The slice's record from Chrome-trace ``events`` (times in us)."""
    spans = [e for e in events if e.get("ph") == "X" and "ts" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    host = [e for e in spans if e.get("cat") in HOST_CATS]
    if not device:
        raise RuntimeError("the profiler recorded no device operation")

    def ends(e):
        a = float(e["ts"])
        return a, a + float(e.get("dur", 0.0))
    t0 = min(ends(e)[0] for e in device + host)
    t1 = max(ends(e)[1] for e in device + host)
    kernels: dict = {}
    intervals = []
    for e in device:
        a, b = ends(e)
        intervals.append((a, b, e.get("name", "")))
        k = kernels.setdefault(e.get("name", ""), [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e6
    launches = sum(1 for e in host if "LaunchKernel" in e.get("name", ""))
    merged = _union([(a, b) for a, b, _ in intervals])
    busy = sum(b - a for a, b in merged) / 1e6
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:N_TOP]
    starts = sorted((a, name) for a, _, name in intervals)
    named = []
    for length, start in gaps:
        mid, end = start + length / 2, start + length
        inner = [e for e in host if ends(e)[0] <= mid <= ends(e)[1]]
        call = min(inner, key=lambda e: float(e.get("dur", 0.0)))["name"] \
            if inner else "no CUDA call"
        after = next((name for a, name in starts if a >= end), "the end")
        named.append([f"{call}; then {after[:100]}", length / 1e6])
    return {"wall_s": (t1 - t0) / 1e6, "busy_s": busy,
            "kernels": {k: {"count": v[0], "seconds": v[1]}
                        for k, v in kernels.items()},
            "launch_calls": launches if host else None,
            "idle_gaps": named}


def breakdown(trace: dict) -> dict:
    """The result's ``breakdown``: the ten device operations that took
    most time, and the ten longest idle gaps by host operation."""
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1]["seconds"])
    return {"device_ops": [[k[:160], v["seconds"]] for k, v in ops[:N_TOP]],
            "idle_gaps": [[k[:160], s] for k, s in trace["idle_gaps"]]}
