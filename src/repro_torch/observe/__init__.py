"""repro_torch.observe — runtime observability (PyTorch port of the JAX
package's ``repro.observe``, in part).

* **Host spans**: :func:`span` context-manager spans recorded by the
  module :data:`RECORDER`, each also entering a
  ``torch.profiler.record_function`` so device timelines align; exported
  as Chrome trace-event JSON (:meth:`SpanRecorder.chrome_trace`).
* **Metrics**: a process-local :class:`MetricsRegistry` (:data:`REGISTRY`)
  of counters, gauges and histograms with Prometheus text exposition
  (:func:`prometheus`) and a JSON snapshot (:func:`snapshot`); the solve
  engine records into it at its chunk boundaries.
* **Clocks**: one protocol (:class:`Clock`) for deadlines and spans;
  :class:`TickingClock` is the deterministic virtual one.

Not ported yet (ROADMAP A7): the iteration-trace ring
(``ConvergenceTrace``), device profiles and the perf trajectory.
"""
from __future__ import annotations

from .clock import SYSTEM_CLOCK, Clock, TickingClock
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      prometheus, snapshot)
from .spans import RECORDER, Span, SpanRecorder, span

__all__ = [
    "Clock", "SYSTEM_CLOCK", "TickingClock",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "prometheus", "snapshot",
    "RECORDER", "Span", "SpanRecorder", "span",
]
