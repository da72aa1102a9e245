"""The traced slice's reduction on a trace made by hand: the union of
device intervals, the launch calls, the gaps and what names them."""
from __future__ import annotations

import pytest

from bench.core import profile


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_takes_the_union_and_names_the_gaps():
    events = [_x("cuda_runtime", "cudaLaunchKernel", 0.0, 1.0),
              _x("kernel", "k1", 2.0, 8.0),
              _x("kernel", "k2", 6.0, 14.0),           # overlaps k1
              _x("cuda_runtime", "cudaLaunchKernel", 24.0, 2.0),
              _x("gpu_memcpy", "Memcpy DtoH", 30.0, 10.0),
              _x("cuda_runtime", "cudaStreamSynchronize", 30.0, 12.0),
              {"ph": "i", "name": "marker", "ts": 5.0}]
    r = profile.reduce(events)
    assert r["wall_s"] == pytest.approx(42e-6)          # 0 .. 42 us
    assert r["busy_s"] == pytest.approx(28e-6)          # 2..20, 30..40
    assert r["launch_calls"] == 2
    assert r["kernels"]["k1"] == {"count": 1, "seconds": pytest.approx(8e-6)}
    assert r["idle_gaps"][0] == ["cudaLaunchKernel; then Memcpy DtoH",
                                 pytest.approx(10e-6)]
    names = [g[0] for g in r["idle_gaps"]]
    assert "cudaStreamSynchronize; then the end" in names
    b = profile.breakdown(r)
    assert b["device_ops"][0][0] == "k2" and len(b["idle_gaps"]) <= 10


def test_reduce_without_device_work_raises():
    with pytest.raises(RuntimeError):
        profile.reduce([_x("cuda_runtime", "cudaLaunchKernel", 0.0, 1.0)])
