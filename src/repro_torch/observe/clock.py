"""One clock protocol for the whole stack (PyTorch port of
``repro.observe.clock``).

Three consumers share one notion of time: the service engine's
deadline clock (``SolveEngine(clock=...)``), the fault-injection
harness's :class:`TickingClock`, and span timestamps.  They all speak the same tiny protocol: a zero-argument
callable returning monotonic seconds.  ``time.monotonic`` satisfies it
(:data:`SYSTEM_CLOCK`); :class:`TickingClock` is the deterministic
virtual implementation tests and benchmarks inject to create deadline
pressure or reproducible span timelines without wall-clock sleeps.

:mod:`repro_torch.resilience.inject` re-exports :class:`TickingClock`,
as the JAX package's does.
"""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Monotonic-seconds source: ``clock() -> float``."""

    def __call__(self) -> float: ...


#: The real clock (``time.monotonic``) — the default everywhere a
#: :class:`Clock` is consumed.
SYSTEM_CLOCK: Clock = time.monotonic


class TickingClock:
    """Virtual monotonic clock: advances ``dt`` per call.

    Inject as ``SolveEngine(..., clock=TickingClock(dt))`` to create
    deterministic deadline pressure — every engine clock read (submit,
    admission, retirement) advances time, no sleeps involved.  The same
    instance can drive a :class:`~repro_torch.observe.SpanRecorder` for
    reproducible span timelines.
    """

    def __init__(self, dt: float = 0.0, t0: float = 0.0):
        self.t = float(t0)
        self.dt = float(dt)

    def __call__(self) -> float:
        self.t += self.dt
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += float(seconds)
