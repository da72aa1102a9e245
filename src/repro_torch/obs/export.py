"""Exporters over the ``repro_torch.obs.trace`` event stream.

Three views of the same records:

* **JSONL** — one ``Event.to_dict()`` per line (the on-disk format the
  ``REPRO_TRACE=<path>`` sink streams); :func:`read_jsonl` round-trips
  it back into :class:`~repro_torch.obs.trace.Event` objects bit-for-bit.
* **Perfetto / Chrome** — ``trace_event`` JSON (``{"traceEvents": [...]}``
  with ``ph`` B/E/i records) loadable in ``ui.perfetto.dev`` or
  ``chrome://tracing``.
* **Summary tree** — plain-text aggregation by span path (call counts,
  total wall time, instant-event tallies): the
  ``python -m repro_torch.obs.summary`` CLI.  The record format is the JAX
  package's, so a JSONL written by either package reads back through the
  other's :func:`read_jsonl`.

The DETERMINISTIC/WALL-CLOCK split is enforced here:
:func:`deterministic_events` strips ``ts_us``/``dur_us`` (and optionally
the ``seq``/``span``/``parent`` ids, which are stable only over a whole
stream, not a filtered slice), so benchmark gates diff payloads that are
pure functions of program behavior.  :func:`checksum` condenses that
view into one pin-able string.

>>> from repro_torch.obs import trace
>>> with trace.capture() as cap:
...     with trace.span("phase", k=1):
...         _ = trace.event("item", i=7)
>>> deterministic_events(cap.events, fields=("kind", "name", "args"))
[{'kind': 'B', 'name': 'phase', 'args': {'k': 1}}, \
{'kind': 'I', 'name': 'item', 'args': {'i': 7}}, \
{'kind': 'E', 'name': 'phase', 'args': None}]
>>> pf = to_perfetto(cap.events)
>>> [e["ph"] for e in pf["traceEvents"]]
['B', 'i', 'E']
"""
from __future__ import annotations

import hashlib
import json
from typing import Iterable, List, Optional, Sequence

from repro_torch.obs.trace import Event

_DET_FIELDS = ("kind", "name", "seq", "span", "parent", "args")


def deterministic_events(events: Iterable[Event],
                         prefix: Optional[str] = None,
                         fields: Sequence[str] = _DET_FIELDS
                         ) -> List[dict]:
    """Gate-safe payload list, in stream order.

    ``prefix`` keeps only events whose name starts with it (e.g.
    ``"serve."``).  For FILTERED streams pass
    ``fields=("kind", "name", "args")``: ``seq``/``span``/``parent``
    number the full stream, so unrelated events (a first-trace autotune
    pick, say) would shift them even though the filtered slice itself is
    unchanged."""
    bad = set(fields) - set(_DET_FIELDS)
    if bad:
        raise ValueError(f"non-deterministic or unknown fields {sorted(bad)}"
                         f"; pick from {_DET_FIELDS}")
    out = []
    for e in events:
        if prefix is not None and not e.name.startswith(prefix):
            continue
        d = e.deterministic()
        out.append({f: d[f] for f in fields})
    return out


def checksum(payloads: List[dict]) -> str:
    """Stable hex digest of a deterministic-payload list — one string a
    benchmark baseline can pin instead of the whole stream."""
    blob = json.dumps(payloads, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


# ---------------------------------------------------------------- JSONL
def to_jsonl(events: Iterable[Event], path: str) -> None:
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e.to_dict(), sort_keys=True) + "\n")


def read_jsonl(path: str) -> List[Event]:
    """Round-trip a JSONL log (sink file or :func:`to_jsonl` output)
    back into :class:`Event` objects."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(Event(d["kind"], d["name"], d["seq"],
                             d.get("span"), d.get("parent"), d.get("args"),
                             d.get("ts_us"), d.get("dur_us")))
    return out


# ------------------------------------------------------------- Perfetto
def to_perfetto(events: Iterable[Event], pid: int = 1,
                tid: int = 1) -> dict:
    """Chrome/Perfetto ``trace_event`` JSON.  ``B``/``E`` map directly;
    instant events become ``ph="i"`` thread-scoped marks.  Events from a
    deterministic-only source (no ``ts_us``) fall back to their ``seq``
    as a synthetic timeline."""
    recs = []
    for e in events:
        ts = e.ts_us if e.ts_us is not None else float(e.seq)
        rec = {"name": e.name, "ph": e.kind if e.kind in ("B", "E") else "i",
               "ts": ts, "pid": pid, "tid": tid}
        if rec["ph"] == "i":
            rec["s"] = "t"
        if e.args:
            rec["args"] = e.args
        recs.append(rec)
    return {"traceEvents": recs, "displayTimeUnit": "ms"}


def write_perfetto(events: Iterable[Event], path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_perfetto(events), f, indent=1, sort_keys=True)


# --------------------------------------------------------- summary tree
class _Node:
    __slots__ = ("name", "calls", "events", "dur_us", "children")

    def __init__(self, name):
        self.name = name
        self.calls = 0       # span begins ("B")
        self.events = 0      # instant events ("I")
        self.dur_us = 0.0    # summed span durations ("E".dur_us)
        self.children = {}

    def child(self, name):
        c = self.children.get(name)
        if c is None:
            c = self.children[name] = _Node(name)
        return c


def _aggregate(events: Iterable[Event]) -> _Node:
    root = _Node("")
    path = [root]
    for e in events:
        if e.kind == "B":
            node = path[-1].child(e.name)
            node.calls += 1
            path.append(node)
        elif e.kind == "E":
            # tolerate unbalanced streams (ring-buffer overflow dropped
            # the matching B): only pop when the top matches
            if len(path) > 1 and path[-1].name == e.name:
                if e.dur_us is not None:
                    path[-1].dur_us += e.dur_us
                path.pop()
        else:
            path[-1].child(e.name).events += 1
    return root


def _fmt_us(us: float) -> str:
    return f"{us / 1e3:.1f}ms" if us >= 1e3 else f"{us:.0f}us"


def summary_tree(events: Iterable[Event]) -> str:
    """Plain-text span tree aggregated by name path: call counts,
    summed wall time (report-only), and instant-event tallies."""
    events = list(events)
    root = _aggregate(events)
    n_spans = sum(1 for e in events if e.kind == "B")
    n_inst = sum(1 for e in events if e.kind == "I")
    lines = [f"trace summary: {len(events)} records "
             f"({n_spans} spans, {n_inst} events)"]

    def render(node, indent):
        kids = list(node.children.values())
        for i, c in enumerate(kids):
            tee = "└─ " if i == len(kids) - 1 else "├─ "
            cont = "   " if i == len(kids) - 1 else "│  "
            if c.calls:
                dur = f", {_fmt_us(c.dur_us)}" if c.dur_us else ""
                extra = f" (+{c.events} events)" if c.events else ""
                lines.append(f"{indent}{tee}{c.name} x{c.calls}{dur}{extra}")
            else:
                lines.append(f"{indent}{tee}[event] {c.name} x{c.events}")
            render(c, indent + cont)

    render(root, "")
    return "\n".join(lines)
