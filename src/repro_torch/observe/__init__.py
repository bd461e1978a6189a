"""repro_torch.observe — runtime observability (PyTorch port of the JAX
package's ``repro.observe``).

One invariant, the JAX package's: zero extra host synchronizations and no
new dependency edge to the in-flight matvec.  What is recorded is either a
value the fused reduction phase already computes, written into an
on-device ring (never read by the iteration: a traced solve is the
untraced one bit for bit), or host-side bookkeeping around program runs.

* **Iteration traces**: ``SolverConfig.trace_cap`` carries a ``(cap, C[,
  m])`` ring through the loop state (relres, the rho / alpha / omega
  denominators, the drift bound, status), written in place at slot
  ``i % cap`` on the device; ``session.solve(..., trace=True)`` returns it
  as a :class:`ConvergenceTrace`.  The service engine harvests each
  retiring request's column with the one host read per chunk it already
  makes.
* **Host spans**: :func:`span` context-manager spans recorded by the
  module :data:`RECORDER`, each also entering a
  ``torch.profiler.record_function`` so device timelines align; exported
  as Chrome trace-event JSON (:meth:`SpanRecorder.chrome_trace`).
* **Metrics**: a process-local :class:`MetricsRegistry` (:data:`REGISTRY`)
  of counters, gauges and histograms with Prometheus text exposition
  (:func:`prometheus`) and a JSON snapshot (:func:`snapshot`).
* **Device profiles** (:mod:`repro_torch.observe.profile`): a solve inside
  a ``torch.profiler`` window, its kernels attributed to the matvec,
  reduce and axpy phases, the overlap efficiency and the exposed
  reduction time per iteration (:class:`ProfileReport`).  Front doors:
  ``session.solve(..., profile=DIR)``, ``ServiceConfig.profile_dir``,
  ``python -m repro_torch.observe profile``.
* **Clocks**: one protocol (:class:`Clock`) for deadlines and spans;
  :class:`TickingClock` is the deterministic virtual one.

``python -m repro_torch.observe smoke`` writes the artifact set and
``report`` renders it.  Not ported yet: the perf trajectory (it reads the
benchmark registry, ROADMAP A10).
"""
from __future__ import annotations

from .clock import SYSTEM_CLOCK, Clock, TickingClock
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      prometheus, snapshot)
from .profile import ProfileReport, analyze_timeline
from .spans import RECORDER, Span, SpanRecorder, span
from .trace import ConvergenceTrace, wrap_trace

__all__ = [
    "Clock", "SYSTEM_CLOCK", "TickingClock",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "prometheus", "snapshot",
    "ProfileReport", "analyze_timeline",
    "RECORDER", "Span", "SpanRecorder", "span",
    "ConvergenceTrace", "wrap_trace",
]
