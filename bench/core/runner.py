"""What a driver is handed and what it hands back, and the pieces the
drivers share: the window's stop rule, the device's sync and peak memory,
and the per-layer readers."""
from __future__ import annotations

import dataclasses
import importlib.util
import time

import torch

from bench.core import cells


@dataclasses.dataclass
class Run:
    cell: cells.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float            # the process's start, ``time.time()`` clock


@dataclasses.dataclass
class Outcome:
    metrics: dict             # end-to-end name -> (value, unit)
    checks: dict              # compared name -> {"value", "limit"}
    attempted: int
    failed: int
    peak_bytes: int
    record: dict | None = None    # what the per-layer readers read


START = [time.time()]      # the process's start (``run.py`` sets it)


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since the
    process started."""
    import sys
    print(f"bench [{time.time() - START[0]:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def allocator_stats(device) -> dict:
    """The caching allocator's retries and device mallocs and frees so far
    (a retry frees the cache and syncs the card), or {} off a card."""
    if device.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(device)
    return {k: s.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc",
                                     "num_device_free")}


def free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def window(units, seconds: float, device):
    """Run ``units`` (an iterator of callables, each one whole step or
    batch of prompts, each ending on the host) from a synchronized
    start until one more would carry the window past ``seconds``, at least
    one.  Returns ``(elapsed seconds, results)``."""
    import gc
    sync(device)
    gc0 = gc.get_stats()[2]["collections"]
    t0 = time.perf_counter()
    done, results, marks = 0, [], [t0]
    for unit in units:
        results.append(unit())
        done += 1
        marks.append(time.perf_counter())
        elapsed = marks[-1] - t0
        if elapsed + elapsed / done > seconds:
            break
    sync(device)
    took = sorted(b - a for a, b in zip(marks, marks[1:]))
    log(f"window: {done} units, each {took[0]:.4f}-{took[-1]:.4f} s "
        f"(median {took[len(took) // 2]:.4f}); "
        f"{gc.get_stats()[2]['collections'] - gc0} full collections; "
        f"allocator {allocator_stats(device)}")
    return time.perf_counter() - t0, results


AHEAD_S = 4.0      # device work queued ahead of the unit the host waits for


def window_ahead(dispatch, seconds: float, device, unit_s: float):
    """Call ``dispatch`` (queues one whole unit on the device and returns
    its result unread) from a synchronized start without waiting on each
    unit: after queueing unit i the host waits for unit i - depth, where
    depth units of ``unit_s`` seconds each make at least ``AHEAD_S``
    seconds.  The CUDA launch queue may hold fewer: then the host runs as
    far ahead as it holds, and waits on no unit before its successors are
    queued.  Once ``seconds`` have passed nothing more is sent; the window
    closes on the clock read after the wait for every unit sent, so all of
    them count over all of that time.  Returns ``(elapsed seconds,
    results)``."""
    import collections
    import gc
    import math
    cuda = device.type == "cuda"
    depth = max(1, math.ceil(AHEAD_S / max(unit_s, 1e-3)))

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    sync(device)
    gc0 = gc.get_stats()[2]["collections"]
    t0 = time.perf_counter()
    marks = [mark()] if cuda else []
    queued, results = collections.deque(), []
    while True:
        results.append(dispatch())
        if cuda:
            marks.append(mark())
            queued.append(marks[-1])
            if len(queued) > depth:
                queued.popleft().synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    took = sorted(a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:]))
    span = (f"each {took[0]:.4f}-{took[-1]:.4f} s on the device's events "
            f"(median {took[len(took) // 2]:.4f})" if took else "")
    log(f"window: {len(results)} units, {depth} queued ahead, {span}; "
        f"{gc.get_stats()[2]['collections'] - gc0} full collections; "
        f"allocator {allocator_stats(device)}")
    return elapsed, results


def readers() -> dict:
    """Every per-layer reader ``bench/metrics/<name>.py`` by name."""
    out = {}
    for name in cells.names("metrics"):
        path = cells.BENCH / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench.metrics.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def per_layer(record: dict) -> dict:
    """``{name: {"value", "unit"}}`` of every reader that found something
    to read in ``record``."""
    out = {}
    for name, mod in readers().items():
        value = mod.read(record)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out
