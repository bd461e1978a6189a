"""Fault tolerance for the training loop (the port's copy of
``repro.train.fault_tolerance``, which holds no JAX).

Mechanisms:

* **Checkpoint/restart** — atomic checkpoints every N steps (see
  checkpoint.py); on (re)start the loop restores the newest complete step
  and the stateless data pipeline replays from exactly that step.
* **Bad-step rejection** — non-finite loss or grad-norm spike (> ``nan_zap``
  x running median) skips the optimizer update for that step; ``max_bad``
  consecutive bad steps aborts to restart-from-checkpoint (round-off /
  hardware-corruption containment).
* **Failure injection** — ``FailureInjector`` raises at configured steps so
  tests can assert end-to-end recovery reproduces the uninterrupted run.
* **Straggler mitigation** — ``StepTimer`` tracks a running median step
  time; steps slower than ``straggler_factor`` x median are logged and
  counted.  Across hosts this signal would feed a coordinator's slow-host
  eviction; in-process we surface the hook + stats.  Synchronous
  data-parallel steps cannot rebalance in-step work, so detection +
  eviction + elastic restart IS the mitigation at this layer.

The same philosophy applied to the solver substrate itself — in-band
detection (the guarded (11, m) fused reduction), typed failure codes,
and policy-driven recovery (restart / residual replacement / substrate
degradation / method fallback) — lives in :mod:`repro_torch.resilience`; the
solve service wires it to serving traffic (``ServiceConfig.recovery``,
:mod:`repro_torch.service.engine`).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np


class FailureInjector:
    """Raises RuntimeError at the given step indices (once each)."""

    def __init__(self, fail_at: Optional[List[int]] = None):
        self.fail_at = set(fail_at or [])

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected failure at step {step}")


class BadStepFilter:
    """Rejects non-finite/spiking steps; aborts after max_bad in a row."""

    def __init__(self, nan_zap: float = 50.0, max_bad: int = 5,
                 window: int = 32):
        self.nan_zap = nan_zap
        self.max_bad = max_bad
        self.norms: deque = deque(maxlen=window)
        self.consecutive_bad = 0
        self.rejected = 0

    def accept(self, loss: float, grad_norm: float) -> bool:
        finite = np.isfinite(loss) and np.isfinite(grad_norm)
        spike = (len(self.norms) >= 8
                 and grad_norm > self.nan_zap * np.median(self.norms))
        ok = finite and not spike
        if ok:
            self.norms.append(grad_norm)
            self.consecutive_bad = 0
        else:
            self.consecutive_bad += 1
            self.rejected += 1
            if self.consecutive_bad > self.max_bad:
                raise RuntimeError(
                    f"{self.consecutive_bad} consecutive bad steps — "
                    "aborting for restart-from-checkpoint")
        return ok


class StepTimer:
    """Running median step time + straggler detection."""

    def __init__(self, straggler_factor: float = 3.0, window: int = 64,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.factor = straggler_factor
        self.times: deque = deque(maxlen=window)
        self.stragglers = 0
        self.on_straggler = on_straggler
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        dt = time.monotonic() - self._t0
        if len(self.times) >= 8 and dt > self.factor * np.median(self.times):
            self.stragglers += 1
            if self.on_straggler:
                self.on_straggler(step, dt)
        self.times.append(dt)
        return dt

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {"median_s": 0.0, "stragglers": 0}
        return {"median_s": float(np.median(self.times)),
                "stragglers": self.stragglers}


def run_with_restarts(run_fn: Callable[[], Dict], max_restarts: int = 3
                      ) -> Dict:
    """Supervisor: rerun ``run_fn`` (which restores from its newest
    checkpoint) after failures, up to ``max_restarts`` times."""
    restarts = 0
    while True:
        try:
            out = run_fn()
            out["restarts"] = restarts
            return out
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
