"""Declarative recovery policies for guarded solves (PyTorch port of
``repro.resilience.policy``).

A :class:`RecoveryPolicy` is a frozen description of what the host may do
when the in-reduction health rows of a guarded solve
(``SolverConfig.guard``; see :mod:`repro_torch.core.multirhs`) flag a
column at a chunk boundary:

* **replace** — on-trigger residual replacement: recompute ``r = b - A x``
  and the recurred A-images from true matvecs when the Cools /
  van der Vorst-Ye drift bound trips;
* **restart** — re-seed the Krylov space from the current iterate after a
  typed breakdown, a non-finite state or stagnation;
* **method fallback** — columns that use up their restarts are solved
  again by a non-pipelined method (default BiCGStab);
* **substrate degradation** — a simulated kernel failure
  (:class:`~repro_torch.resilience.SimulatedKernelFailure`) on ``"cuda"``
  rebuilds the session on ``"torch"``, on the same device, and continues
  from the same state; a real one is raised.

* **service retries** — the solve engine re-enqueues failed requests with
  a capped exponential backoff (:mod:`repro_torch.service`).

:class:`repro_torch.resilience.GuardedSolver` interprets the policy and
logs every action in its ``events``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import SOLVERS


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """What a guarded solve may do about an unhealthy column; fields,
    defaults and checks as in ``repro.resilience.RecoveryPolicy``.

    Attributes:
      max_restarts: per-column budget of restart-from-current-x events.
      max_replacements: per-column budget of residual replacements.
      stagnation_window: consecutive non-improving iterations before a
        column is stagnant (forwarded to ``SolverConfig``; 0 disables).
      drift_scale: drift threshold multiplier (forwarded to
        ``SolverConfig``; 0 means 1.0).
      method_fallback: a name of :data:`repro_torch.core.SOLVERS` run on
        columns still broken after all restarts (``None`` disables it).
      substrate_fallback: rebuild on ``"torch"`` after a simulated kernel
        failure.
      chunk: iterations between two host reads of the health flags.
      max_retries: how often the solve engine re-enqueues a failed
        request (its rid stays).
      retry_backoff_s / retry_backoff_cap_s: the engine's retry backoff,
        ``retry_backoff_s * 2**(attempt - 1)`` seconds, at most the cap.
    """

    max_restarts: int = 2
    max_replacements: int = 4
    stagnation_window: int = 0
    drift_scale: float = 0.0
    method_fallback: Optional[str] = "bicgstab"
    substrate_fallback: bool = True
    chunk: int = 64
    max_retries: int = 1
    retry_backoff_s: float = 0.0
    retry_backoff_cap_s: float = 1.0

    def __post_init__(self):
        if self.method_fallback is not None:
            if self.method_fallback not in SOLVERS:
                raise ValueError(
                    f"unknown method_fallback {self.method_fallback!r}; "
                    f"expected one of {sorted(SOLVERS)} or None")
        if self.chunk < 1:
            raise ValueError("chunk must be >= 1")
        for name in ("max_restarts", "max_replacements", "max_retries"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
