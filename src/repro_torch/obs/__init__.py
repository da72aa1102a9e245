"""Observability: structured tracing, a metrics registry and a signature
sentinel, the twins of the JAX package's ``repro.obs``.

Host-side and deterministic-friendly by construction:

* ``repro_torch.obs.trace``    — hierarchical spans + events, ring buffer,
  ``REPRO_TRACE=0/1/<jsonl-path>`` gating (zero-cost when off);
* ``repro_torch.obs.metrics``  — process-wide counters/gauges/histograms
  with labeled series, ``snapshot()``/``reset()``, and the ``timeit`` loop
  (it synchronises CUDA when a result holds CUDA tensors);
* ``repro_torch.obs.export``   — JSONL / Perfetto ``trace_event`` /
  summary-tree views with deterministic payloads split from report-only
  wall clock; the JSONL records are the JAX package's;
* ``repro_torch.obs.shapemon`` — the signature sentinel (``monitor`` +
  ``assert_max_traces``), the twin of ``jaxmon``: eager PyTorch has no
  traces, so it counts the distinct input signatures a function sees.

No obs call sits inside a ``torch.autograd.Function``'s ``forward`` or
``backward`` or inside a kernel wrapper (``tests/test_torch_hygiene.py``):
the instrumented points are host-side decisions (prepare, dispatch,
autotune, the scheduler, the engine and the train loop).
"""
from repro_torch.obs import export, metrics, shapemon, trace
from repro_torch.obs.metrics import counter, gauge, histogram, snapshot, timeit
from repro_torch.obs.trace import capture, enabled, event, span, spanned

__all__ = [
    "trace", "metrics", "export", "shapemon",
    "span", "spanned", "event", "capture", "enabled",
    "counter", "gauge", "histogram", "snapshot", "timeit",
]
