"""Signature sentinel: make static-shape promises checked facts.

The serving engine's decode call and the paged decode gather promise that
their inputs keep one shape whatever the scheduler does (slot masks keep
the batch ``n_slots`` rows wide; the page table keeps ``max_bpr`` slots).
The JAX package checks that promise by counting jit retraces
(``repro.obs.jaxmon``).  Eager PyTorch has no traces, so this twin counts
what a jit cache keys on: the **distinct abstract input signatures** a
function has been called with.  A tensor argument contributes its shape,
dtype and device; a list, tuple or dict contributes the signatures of its
items; any other argument contributes its type, never its value (decode's
``pos`` is a Python ``int``, so the positions a run walks through count
once).  "Never retraces" then reads "sees one signature".

:func:`monitor` wraps a function; each call computes the signature, and a
signature not seen before bumps the named :class:`Sentinel` and emits a
``torch.signature`` event (where ``jaxmon`` emits ``jax.trace``).
``assert_max_traces(target, n)`` raises :class:`RetraceError` when more
than ``n`` signatures were seen.  The public names are ``jaxmon``'s, so
``trace_count`` counts signatures here.

Signatures are computed on every call (a tuple per argument, on the host);
nothing reads a tensor's values, so no call waits for the device.

>>> import torch
>>> @monitor(name="doc.f")
... def f(x, pos):
...     return x * pos
>>> _ = f(torch.ones(4), 1); _ = f(torch.ones(4), 2)  # one signature
>>> trace_count("doc.f")
1
>>> _ = f(torch.ones(8), 3)                           # a new shape
>>> assert_max_traces("doc.f", 1)   # doctest: +IGNORE_EXCEPTION_DETAIL
Traceback (most recent call last):
    ...
RetraceError: doc.f: saw 2 signatures, budget 1
>>> reset("doc.f")
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, Optional

from repro_torch.obs import trace as _trace


class RetraceError(AssertionError):
    """A monitored entry point saw more input signatures than its budget."""


class Sentinel:
    """The distinct input signatures one monitored function has seen."""
    __slots__ = ("name", "count", "_seen", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._seen = set()
        self._lock = threading.Lock()

    def observe(self, sig) -> int:
        """Record ``sig``; returns the new count when it is new, else 0."""
        with self._lock:
            if sig in self._seen:
                return 0
            self._seen.add(sig)
            self.count += 1
            return self.count

    def reset(self) -> None:
        with self._lock:
            self._seen.clear()
            self.count = 0

    def __repr__(self):
        return f"Sentinel({self.name!r}, count={self.count})"


_REGISTRY: Dict[str, Sentinel] = {}
_LOCK = threading.Lock()


def _signature(x):
    """Abstract signature of one argument: shape, dtype and device of an
    array-like (anything with ``shape`` and ``dtype``), the items' of a
    list, tuple or dict, else the type alone."""
    shape = getattr(x, "shape", None)
    if shape is not None and hasattr(x, "dtype"):
        return (type(x).__name__, tuple(shape), str(x.dtype),
                str(getattr(x, "device", "host")))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_signature(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, _signature(x[k])) for k in sorted(x)))
    return type(x).__name__


def monitor(fn=None, *, name: Optional[str] = None):
    """Decorator/wrapper installing a signature sentinel on ``fn``.

    Registers the sentinel process-wide under ``name`` (default: the
    function's qualname; the latest registration wins: each
    ``ServeEngine`` registers ``serve.masked_step`` for its own decode
    call).  The sentinel is also reachable as ``wrapped.sentinel``."""
    if fn is None:
        return functools.partial(monitor, name=name)
    s = Sentinel(name or getattr(fn, "__qualname__", repr(fn)))
    with _LOCK:
        _REGISTRY[s.name] = s

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        sig = (tuple(_signature(v) for v in a),
               tuple((k, _signature(kw[k])) for k in sorted(kw)))
        n = s.observe(sig)
        if n:
            _trace.event("torch.signature", fn=s.name, n=n)
        return fn(*a, **kw)

    wrapper.sentinel = s
    return wrapper


def _resolve(target) -> Sentinel:
    if isinstance(target, Sentinel):
        return target
    if isinstance(target, str):
        s = _REGISTRY.get(target)
        if s is None:
            known = sorted(_REGISTRY)
            raise KeyError(f"no signature sentinel named {target!r}; "
                           f"registered: {known}")
        return s
    s = getattr(target, "sentinel", None)
    if isinstance(s, Sentinel):
        return s
    raise TypeError(f"expected a sentinel name, a monitored function, or "
                    f"a Sentinel; got {target!r}")


def trace_count(target) -> int:
    """How many distinct input signatures the monitored function saw."""
    return _resolve(target).count


def assert_max_traces(target, n: int) -> None:
    """Raise :class:`RetraceError` when ``target`` saw more than ``n``
    signatures: a static-shape promise broke."""
    s = _resolve(target)
    if s.count > n:
        raise RetraceError(
            f"{s.name}: saw {s.count} signatures, budget {n} — a "
            "static-shape promise broke (inputs of another shape, dtype or "
            "device reached a monitored entry point)")


def reset(target=None) -> None:
    """Zero one sentinel, or every registered sentinel (test isolation)."""
    if target is not None:
        _resolve(target).reset()
        return
    with _LOCK:
        for s in _REGISTRY.values():
            s.reset()


def sentinels() -> Dict[str, int]:
    """Snapshot ``{name: signature count}`` of every registered sentinel."""
    with _LOCK:
        return {name: s.count for name, s in sorted(_REGISTRY.items())}
