"""Request/response types and configuration for the solve service (PyTorch
port of ``repro.service.types``).

A :class:`SolveRequest` is one right-hand side against one registered
operator, with its own ``tol`` / ``maxiter`` / ``deadline``; the engine
multiplexes heterogeneous requests onto one resident ``(n, max_batch)``
block (see :mod:`repro_torch.service.engine`) and returns a
:class:`RequestResult` per request, carrying the same solver fields as a
standalone :class:`repro_torch.core.SolveResult` column plus serving
telemetry (queue wait, chunks resident, wall time).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ..core.types import SolveStatus
from ..resilience.policy import RecoveryPolicy


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Static engine configuration; fields and defaults as in the JAX
    package but for ``substrate`` and ``device``.

    Attributes:
      max_batch: slots in the resident block, the m of its ``(n, m)``
        program.  Request mix never changes it (empty slots ride along
        frozen), so nothing is rebuilt or captured again under load.
      chunk: iterations per engine step.  A chunk is one run of the
        block's program (one CUDA graph replay on the card) followed by
        one host read of the flags; retirement and refill happen only at
        chunk boundaries.
      substrate: ``"torch"`` (plain PyTorch) or ``"cuda"`` (the
        hand-written kernels), or a :class:`repro_torch.core.Substrate`.
      tol / maxiter: per-request defaults when the request leaves them
        unset (``maxiter`` is also the per-column budget the program
        enforces on the device).
      recovery: ``None`` serves unguarded.  A :class:`repro_torch
        .resilience.RecoveryPolicy` turns on guarded serving: the blocks
        step with ``SolverConfig.guard`` (the (11, m) health rows, still
        one reduction per iteration), broken columns retire with their
        typed :class:`~repro_torch.core.SolveStatus`, non-finite columns
        are scrubbed before their slot is reused, and failed requests are
        re-enqueued up to ``recovery.max_retries`` times with capped
        exponential backoff.
      trace_cap: per-column iteration-trace ring capacity
        (``SolverConfig.trace_cap``) of the resident blocks.  0 serves
        untraced; when set, every retirement carries its column's
        :class:`~repro_torch.observe.ConvergenceTrace` as
        ``RequestResult.trace``, harvested with the one host read per chunk
        the engine already makes (size it to at least ``chunk``, so a
        column's terminal row is still in the ring when it retires).
      profile_dir: when set, :meth:`SolveEngine.run` runs inside a device
        profile capture (:mod:`repro_torch.observe.profile`) and leaves
        the report on ``engine.last_profile`` and
        ``profile_dir/profile.json``; results are the same.
      device: where the blocks live; ``None`` means ``"cuda"`` (raising
        without a GPU); pass ``"cpu"`` to serve on the CPU.
    """

    max_batch: int = 8
    chunk: int = 32
    substrate: Any = "torch"
    tol: float = 1e-8
    maxiter: int = 10_000
    recovery: Optional[RecoveryPolicy] = None
    trace_cap: int = 0
    profile_dir: Optional[str] = None
    device: Any = None

    def __post_init__(self):
        if self.max_batch < 1 or self.chunk < 1:
            raise ValueError("max_batch and chunk must be >= 1")


@dataclasses.dataclass
class SolveRequest:
    """One right-hand side against a registered operator.

    ``tol``/``maxiter`` default from :class:`ServiceConfig`; ``deadline``
    is a wall-clock budget in seconds from submission: a request still in
    flight past its deadline is retired unconverged at the next chunk
    boundary (its partial iterate is returned).

    ``b`` is staged on the host (numpy) by the engine: it is consumed
    only when the host assembles an admission block, so there is one
    copy to the device per block, not per request.
    """

    operator: str
    b: np.ndarray
    tol: Optional[float] = None
    maxiter: Optional[int] = None
    deadline: Optional[float] = None
    rid: int = -1
    # host-side bookkeeping (filled by the engine)
    t_submit: float = 0.0
    t_start: Optional[float] = None
    chunks_resident: int = 0
    #: retry attempts consumed so far (guarded serving); the rid is stable
    #: across retries
    retries: int = 0
    #: earliest clock time this request may next occupy a slot (retry
    #: backoff; 0.0 = at once)
    not_before: float = 0.0


@dataclasses.dataclass(frozen=True)
class RequestTelemetry:
    """Serving telemetry for one completed request."""

    queue_wait_s: float       # submit -> first resident in the block
    service_s: float          # first resident -> retirement
    wall_s: float             # submit -> retirement
    chunks_resident: int      # engine chunks the request stayed resident
    deadline_exceeded: bool


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Per-request outcome: the solver fields a standalone ``solve_many``
    column would report, plus telemetry.

    ``status`` is the typed :class:`~repro_torch.core.SolveStatus` of the
    retirement (guarded serving: the in-reduction per-column code;
    unguarded: the coarse classification; deadline expiry is ``DEADLINE``
    either way).  ``retries`` counts how often the engine ran the request
    again before this outcome.  ``trace`` is the request's per-iteration
    :class:`~repro_torch.observe.ConvergenceTrace` when the engine serves
    with ``ServiceConfig.trace_cap`` set (``None`` otherwise).
    """

    rid: int
    operator: str
    x: np.ndarray
    iterations: int
    relres: float
    converged: bool
    breakdown: bool
    telemetry: RequestTelemetry
    status: SolveStatus = SolveStatus.CONVERGED
    retries: int = 0
    trace: Optional[Any] = None
