"""Structured tracing: hierarchical spans + instant events in a
thread-safe ring buffer.

Enablement comes from ``REPRO_TRACE`` at import (or :func:`configure` /
:class:`capture` later):

* unset / ``""`` / ``"0"`` — disabled.  ``event()`` returns immediately
  and ``span()`` hands back one shared no-op object, so instrumented hot
  paths never allocate inside this module;
* ``"1"`` — enabled, in-memory ring buffer only;
* anything else — treated as a JSONL path: every record is appended to
  the file as it is emitted (and kept in the ring buffer).

Every record is an :class:`Event` with a DETERMINISTIC payload — ``kind``
(``"B"`` span begin / ``"E"`` span end / ``"I"`` instant), ``name``,
``seq`` (emission order), ``span`` / ``parent`` (span ids = the begin
event's seq), and ``args`` — plus REPORT-ONLY wall-clock fields
(``ts_us``, ``dur_us``).  Exporters (``repro_torch.obs.export``) keep the two
groups separate so benchmark gating stays falsifiable: a CI diff may pin
the deterministic view bit-for-bit while timings remain informational.

Span names are dot-scoped ``<layer>.<what>`` (``prepare.reorder``,
``autotune.tune``, ``serve.step``) and are the JAX package's, as are the
records: a stream from either package reads back through the other's
``export.read_jsonl``.  The module is host-only and imports no torch.

>>> with capture() as cap:
...     with span("outer", n=2):
...         _ = event("tick", i=0)
>>> [(e.kind, e.name) for e in cap.events]
[('B', 'outer'), ('I', 'tick'), ('E', 'outer')]
>>> cap.events[1].deterministic() == {'kind': 'I', 'name': 'tick',
...     'seq': 1, 'span': None, 'parent': 0, 'args': {'i': 0}}
True
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from typing import Iterable, List, Optional

_DEFAULT_CAP = 65536
_SELF = object()          # sentinel: "span id = this event's own seq"


def _jsonify(v):
    """Coerce an args value into plain JSON types, so the deterministic
    payload is serializable and stable across in-memory / JSONL views
    (tuples -> lists, numpy scalars and tensors -> python values)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonify(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonify(x) for k, x in v.items()}
    item = getattr(v, "item", None)     # numpy/torch scalars, 0-d arrays
    if callable(item):
        try:
            return _jsonify(item())
        except (TypeError, ValueError, RuntimeError):  # torch: several elems
            pass
    tolist = getattr(v, "tolist", None)  # numpy arrays, tensors
    if callable(tolist):
        return _jsonify(tolist())
    return repr(v)


class Event:
    """One trace record; see the module docstring for the field contract."""
    __slots__ = ("kind", "name", "seq", "span", "parent", "args",
                 "ts_us", "dur_us")

    def __init__(self, kind, name, seq, span=None, parent=None, args=None,
                 ts_us=None, dur_us=None):
        self.kind = kind
        self.name = name
        self.seq = seq
        self.span = span
        self.parent = parent
        self.args = args
        self.ts_us = ts_us
        self.dur_us = dur_us

    def deterministic(self) -> dict:
        """The gate-safe payload: no wall-clock fields."""
        return {"kind": self.kind, "name": self.name, "seq": self.seq,
                "span": self.span, "parent": self.parent,
                "args": self.args}

    def to_dict(self) -> dict:
        d = self.deterministic()
        if self.ts_us is not None:
            d["ts_us"] = self.ts_us
        if self.dur_us is not None:
            d["dur_us"] = self.dur_us
        return d

    def __repr__(self):
        return (f"Event({self.kind!r}, {self.name!r}, seq={self.seq}, "
                f"args={self.args!r})")


class _TraceState:
    """One live buffer (+ optional JSONL sink).  All mutation is under
    ``lock`` so concurrent emitters interleave at record granularity."""

    def __init__(self, path: Optional[str] = None,
                 cap: int = _DEFAULT_CAP):
        self.events: deque = deque(maxlen=cap)
        self.lock = threading.Lock()
        self.path = path
        self._sink = None
        self._seq = 0
        self.t0 = time.perf_counter()

    def emit(self, kind, name, span, parent, args, ts_us, dur_us=None):
        with self.lock:
            seq = self._seq
            self._seq += 1
            if span is _SELF:
                span = seq
            ev = Event(kind, name, seq, span, parent, args, ts_us, dur_us)
            self.events.append(ev)
            if self.path is not None:
                if self._sink is None:
                    self._sink = open(self.path, "a")
                self._sink.write(
                    json.dumps(ev.to_dict(), sort_keys=True) + "\n")
                self._sink.flush()
            return ev

    def close(self):
        if self._sink is not None:
            self._sink.close()
            self._sink = None


_state: Optional[_TraceState] = None
_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def enabled() -> bool:
    """True when a trace buffer is installed (env or capture())."""
    return _state is not None


def _now_us(state: _TraceState) -> float:
    return round((time.perf_counter() - state.t0) * 1e6, 3)


def event(name: str, **args) -> Optional[Event]:
    """Emit one instant event under the current span (no-op when
    tracing is disabled)."""
    st = _state
    if st is None:
        return None
    stack = _stack()
    parent = stack[-1] if stack else None
    return st.emit("I", name, None, parent,
                   {k: _jsonify(v) for k, v in args.items()} or None,
                   _now_us(st))


def timed_event(name: str, dur_us: float, **args) -> Optional[Event]:
    """An instant event carrying a report-only duration (``obs.timeit``
    uses this: the measurement rides in the wall-clock field, never in
    the deterministic args)."""
    st = _state
    if st is None:
        return None
    stack = _stack()
    parent = stack[-1] if stack else None
    return st.emit("I", name, None, parent,
                   {k: _jsonify(v) for k, v in args.items()} or None,
                   _now_us(st), round(float(dur_us), 3))


class _NullSpan:
    """Shared no-op returned by ``span()`` while tracing is disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "_id", "_t0")

    def __init__(self, name, args):
        self.name = name
        self.args = args
        self._id = None
        self._t0 = 0.0

    def __enter__(self):
        st = _state
        if st is None:           # disabled between construction and entry
            self._id = None
            return self
        stack = _stack()
        parent = stack[-1] if stack else None
        ev = st.emit("B", self.name, _SELF, parent,
                     {k: _jsonify(v) for k, v in self.args.items()} or None,
                     _now_us(st))
        self._id = ev.seq
        stack.append(ev.seq)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._id is None:
            return False
        dur = round((time.perf_counter() - self._t0) * 1e6, 3)
        stack = _stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        parent = stack[-1] if stack else None
        st = _state
        if st is not None:
            st.emit("E", self.name, self._id, parent, None,
                    _now_us(st), dur)
        self._id = None
        return False


def span(name: str, **args):
    """Context manager opening a hierarchical span.  Zero-cost while
    disabled: the same shared no-op object comes back every call."""
    if _state is None:
        return _NULL_SPAN
    return _Span(name, args)


def spanned(name: Optional[str] = None, **static_args):
    """Decorator form of :func:`span`; enablement is re-checked per call,
    so functions decorated at import time still trace under a later
    ``capture()``."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if _state is None:
                return fn(*a, **kw)
            with _Span(label, dict(static_args)):
                return fn(*a, **kw)
        return wrapper
    return deco


def get_events() -> List[Event]:
    """Snapshot of the current ring buffer (empty list when disabled)."""
    st = _state
    if st is None:
        return []
    with st.lock:
        return list(st.events)


class capture:
    """Install a fresh in-memory trace buffer for the ``with`` block —
    regardless of ``REPRO_TRACE`` — and restore the previous state after.
    The span stack is saved/cleared on entry so captured streams are
    self-contained.  ``cap.events`` snapshots the buffer (valid after
    exit too)."""

    def __init__(self, path: Optional[str] = None, cap: int = _DEFAULT_CAP):
        self._path = path
        self._cap = cap
        self._buf = None
        self._saved = None
        self._saved_stack = None

    def __enter__(self):
        global _state
        self._saved = _state
        self._saved_stack = list(_stack())
        _stack().clear()
        _state = _TraceState(path=self._path, cap=self._cap)
        self._buf = _state
        return self

    def __exit__(self, *exc):
        global _state
        self._buf.close()
        _state = self._saved
        _stack()[:] = self._saved_stack
        return False

    @property
    def events(self) -> List[Event]:
        with self._buf.lock:
            return list(self._buf.events)


def configure(mode: Optional[str], cap: Optional[int] = None) -> None:
    """(Re)install the process trace state from a ``REPRO_TRACE``-style
    value: ``None``/``""``/``"0"`` disable, ``"1"`` memory-only, anything
    else is a JSONL sink path."""
    global _state
    if _state is not None:
        _state.close()
    cap = cap or int(os.environ.get("REPRO_TRACE_CAP", _DEFAULT_CAP))
    if mode is None or mode in ("", "0"):
        _state = None
    elif mode == "1":
        _state = _TraceState(cap=cap)
    else:
        _state = _TraceState(path=mode, cap=cap)


def deterministic_payloads(events: Iterable[Event]) -> List[dict]:
    """Convenience passthrough to the exporter's gate-safe view."""
    return [e.deterministic() for e in events]


configure(os.environ.get("REPRO_TRACE"))
