"""Process-wide metrics registry: counters, gauges, histograms with
labeled series, snapshot + reset semantics.

Unlike ``repro_torch.obs.trace`` (ring buffer, gated by ``REPRO_TRACE``), the
registry is always live — a metric update is one dict lookup and one
arithmetic op, cheap enough to leave on unconditionally.  Series are
keyed by ``name`` plus sorted ``label=value`` pairs, so
``counter("ops.dispatch", op="spmm")`` and
``counter("ops.dispatch", op="sddmm")`` are independent.

``snapshot()`` renders everything into plain JSON types (safe to dump);
``reset()`` forgets every series — tests and benchmark harnesses call it
between runs so accumulation windows are explicit.

>>> reset()
>>> counter("demo.hits", op="spmm").inc()
>>> counter("demo.hits", op="spmm").inc(2)
>>> gauge("demo.level").set(0.5)
>>> snap = snapshot()
>>> snap["counters"]["demo.hits{op=spmm}"]
3
>>> snap["gauges"]["demo.level"]
0.5
>>> reset(); snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
True
"""
from __future__ import annotations

import statistics
import threading
import time
from typing import Dict, Optional, Tuple

from repro_torch.obs import trace as _trace

# default histogram bucket upper bounds (values <= bound); one catch-all
# "inf" bucket is always appended
_DEFAULT_BOUNDS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000)


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    __slots__ = ("bounds", "buckets", "count", "sum", "min", "max")

    def __init__(self, bounds: Tuple[float, ...] = _DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    def snapshot(self) -> dict:
        keys = [f"le_{b}" for b in self.bounds] + ["inf"]
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "buckets": dict(zip(keys, self.buckets))}


def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Registry:
    """One metrics namespace; the module-level default is process-wide."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name, labels, cls, *args):
        key = _series_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(*args)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {key!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Tuple[float, ...]] = None,
                  **labels) -> Histogram:
        return self._get(name, labels, Histogram,
                         *(() if bounds is None else (tuple(bounds),)))

    def snapshot(self) -> dict:
        with self._lock:
            out = {"counters": {}, "gauges": {}, "histograms": {}}
            for key, m in sorted(self._metrics.items()):
                if isinstance(m, Counter):
                    out["counters"][key] = m.value
                elif isinstance(m, Gauge):
                    out["gauges"][key] = m.value
                else:
                    out["histograms"][key] = m.snapshot()
            return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def counter(name: str, **labels) -> Counter:
    return _REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _REGISTRY.gauge(name, **labels)


def histogram(name: str, bounds: Optional[Tuple[float, ...]] = None,
              **labels) -> Histogram:
    return _REGISTRY.histogram(name, bounds, **labels)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def reset() -> None:
    _REGISTRY.reset()


# --------------------------------------------------------------- timing
def _holds_cuda(x) -> bool:
    """True when ``x`` (a tensor, or a list, tuple or dict of them) holds a
    tensor on a CUDA device."""
    if isinstance(x, (list, tuple)):
        return any(_holds_cuda(v) for v in x)
    if isinstance(x, dict):
        return any(_holds_cuda(v) for v in x.values())
    return getattr(getattr(x, "device", None), "type", None) == "cuda"


def _block(x):
    """Wait for the device work behind ``x``: kernels run asynchronously,
    so a host clock read before the result is ready would time the
    enqueue.  Imports torch only when ``x`` holds a CUDA tensor."""
    if _holds_cuda(x):
        import torch
        torch.cuda.synchronize()
    return x


def timeit(fn, *args, warmup: int = 1, iters: int = 5,
           reduce: str = "median", name: Optional[str] = None,
           **kwargs) -> float:
    """Wall-clock seconds of ``fn(*args, **kwargs)``: the benchmark timing
    loop.

    ``warmup`` calls run first (kernel builds, first-call set-up), then
    ``iters`` timed calls reduce by ``"median"`` or ``"min"``.  Each call's
    result is waited for with ``torch.cuda.synchronize()`` when it holds a
    CUDA tensor, so asynchronous launches cannot fake a fast run.  The
    measurement is REPORT-ONLY wall clock: when ``name`` is given it lands
    in the ``obs`` stream as a timed event's ``dur_us`` and in the
    ``bench.<name>`` histogram, never in a deterministic field.
    """
    if reduce not in ("median", "min"):
        raise ValueError(f"reduce must be 'median' or 'min', got {reduce!r}")
    for _ in range(max(int(warmup), 0)):
        _block(fn(*args, **kwargs))
    ts = []
    for _ in range(max(int(iters), 1)):
        t0 = time.perf_counter()
        _block(fn(*args, **kwargs))
        ts.append(time.perf_counter() - t0)
    sec = float(min(ts) if reduce == "min" else statistics.median(ts))
    if name is not None:
        _REGISTRY.histogram(f"bench.{name}").observe(sec * 1e6)
        _trace.timed_event(f"bench.{name}", sec * 1e6,
                           iters=len(ts), reduce=reduce)
    return sec
