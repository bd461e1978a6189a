"""Structured host-side span tracing, aligned with device timelines
(PyTorch port of ``repro.observe.spans``).

A span is one timed host-side phase of the stack: an engine chunk, an
admission, a retirement.  Spans nest (context managers) and each one also
enters a ``torch.profiler.record_function`` of the same name, so when the
user captures a ``torch.profiler`` trace the host spans line up against
the device timeline in the same viewer.

Nothing here touches device values: recording a span is two clock reads
and a list append.  The solver loop itself is never spanned; spans cover
the dispatch granularity the host controls.

Export is Chrome trace-event JSON (:meth:`SpanRecorder.chrome_trace`),
loadable in Perfetto / ``chrome://tracing``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict

import torch

from .clock import SYSTEM_CLOCK, Clock


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed span: ``[start, end]`` in clock seconds."""

    name: str
    start: float
    end: float
    tid: int
    args: Dict[str, Any]

    @property
    def duration(self) -> float:
        return self.end - self.start


class SpanRecorder:
    """Bounded in-process span buffer.

    ``clock`` is any :class:`~repro_torch.observe.Clock` (inject a
    :class:`~repro_torch.observe.TickingClock` for deterministic timelines
    in tests); ``cap`` bounds memory: a long-running engine keeps the LAST
    ``cap`` spans.  Thread-safe.
    """

    def __init__(self, clock: Clock = SYSTEM_CLOCK, cap: int = 8192):
        self.clock = clock
        self._spans: Deque[Span] = deque(maxlen=int(cap))
        self._lock = threading.Lock()
        self.enabled = True

    @contextmanager
    def span(self, name: str, **args):
        """Record ``name`` around the with-block (and annotate the device
        timeline with the same name).  Non-string arg values are kept as
        they are; they are stringified only at export."""
        if not self.enabled:
            yield
            return
        t0 = self.clock()
        with torch.profiler.record_function(name):
            try:
                yield
            finally:
                self._record(name, t0, self.clock(), args)

    def _record(self, name, t0, t1, args):
        sp = Span(name=name, start=t0, end=t1,
                  tid=threading.get_ident(), args=dict(args))
        with self._lock:
            self._spans.append(sp)

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- export -----------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (``ph: "X"`` complete events, µs)."""
        events = []
        for sp in self.spans():
            events.append({
                "name": sp.name, "ph": "X",
                "ts": sp.start * 1e6, "dur": sp.duration * 1e6,
                "pid": os.getpid(), "tid": sp.tid,
                "args": {k: (v if isinstance(v, (int, float, bool))
                             else str(v)) for k, v in sp.args.items()},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save_chrome_trace(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)


#: The process-default recorder every instrumented layer records into.
RECORDER = SpanRecorder()


def span(name: str, **args):
    """``with observe.span("engine.chunk", operator=name): ...``: the
    module-level shorthand for :data:`RECORDER`'s context manager."""
    return RECORDER.span(name, **args)
