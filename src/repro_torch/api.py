"""repro_torch.api — the front door: bind-once ``LinearSolver`` sessions
(PyTorch port of ``repro.api``).

    import repro_torch

    solver = repro_torch.make_solver("p-bicgsafe", op, substrate="cuda")
    res = solver.solve(b)                   # on the card
    res = repro_torch.solve(op, b)          # one-shot

``device=None`` means ``"cuda"``, and raises when no GPU is present: pass
``device="cpu"`` to run on the CPU.  The operator's tensors must lie on the
session's device.

Not ported yet, and raising :class:`NotImplementedError`: ``precond=``,
``recovery=``, ``solve(trace=..., profile=...)``, ``solve_many`` and
``on_mesh``.  Sessions are not cached by operator content.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .core import SOLVERS
from .core.substrate import SubstrateLike, get_substrate
from .core.types import SolveResult, SolverConfig, resolve_device

__all__ = ["LinearSolver", "make_solver", "solve"]


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet")


def _operator_device(op) -> Optional[torch.device]:
    if isinstance(op, torch.Tensor):
        return op.device
    return getattr(op, "device", None)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class LinearSolver:
    """One method bound to one operator: build once, solve many times.

    Attributes:
      method / operator / config / device: as bound.
      sub: the resolved :class:`~repro_torch.core.substrate.Substrate`.
      stats: ``{"solves", "steps", "rr_steps", "host_reads"}`` summed over
        this session's solves: iterations queued (stopped ones included),
        residual-replacement steps and host reads of the stop flag.
    """

    def __init__(self, method: str, operator, *,
                 substrate: SubstrateLike = "torch",
                 config: SolverConfig = SolverConfig(),
                 device=None):
        if method not in SOLVERS:
            raise ValueError(f"unknown method {method!r}; expected one of "
                             f"{sorted(SOLVERS)}")
        self.method = method
        self.operator = operator
        self.config = config
        self.device = resolve_device(device)
        op_device = _operator_device(operator)
        if op_device is not None and not _same_device(op_device, self.device):
            raise ValueError(f"the operator lies on {op_device}, the session "
                             f"on {self.device}")
        self.sub = get_substrate(substrate)
        self.stats: Dict[str, int] = {"solves": 0, "steps": 0,
                                      "rr_steps": 0, "host_reads": 0}

    def _derive(self, tol, maxiter) -> SolverConfig:
        cfg = self.config
        if tol is not None:
            cfg = dataclasses.replace(cfg, tol=float(tol))
        if maxiter is not None:
            cfg = dataclasses.replace(cfg, maxiter=int(maxiter))
        return cfg

    def _tensor(self, v):
        if v is None:
            return None
        if isinstance(v, np.ndarray) and not v.flags.writeable:
            v = v.copy()            # torch.as_tensor warns on read-only data
        return torch.as_tensor(v, device=self.device)

    def solve(self, b, x0=None, *, tol=None, maxiter=None, r0_star=None,
              trace=None, profile=None) -> SolveResult:
        """Solve A x = b.  ``tol``/``maxiter`` override the bound config;
        ``x0``/``r0_star`` as for the free functions."""
        if trace:
            raise _not_ported("solve(trace=...)")
        if profile is not None:
            raise _not_ported("solve(profile=...)")
        cfg = self._derive(tol, maxiter)
        self.stats["solves"] += 1
        return SOLVERS[self.method](
            self.operator, self._tensor(b), self._tensor(x0), config=cfg,
            r0_star=self._tensor(r0_star), substrate=self.sub,
            stats=self.stats)

    def solve_many(self, *args, **kwargs):
        raise _not_ported("solve_many (multi-RHS solves)")

    def on_mesh(self, *args, **kwargs):
        raise _not_ported("on_mesh (distributed solves)")


def make_solver(method: str = "p-bicgsafe", operator=None, *,
                precond=None,
                substrate: SubstrateLike = "torch",
                config: SolverConfig = SolverConfig(),
                device=None,
                recovery=None) -> LinearSolver:
    """Bind ``method`` (a name from :data:`repro_torch.core.SOLVERS`) to
    ``operator`` (Dense/CSR/ELL/Stencil7, a dense matrix, or a matvec
    callable) on ``device`` (``None`` means ``"cuda"``)."""
    if operator is None:
        raise TypeError("make_solver requires an operator")
    if precond is not None:
        raise _not_ported("precond=")
    if recovery is not None and recovery is not False:
        raise _not_ported("recovery=")
    return LinearSolver(method, operator, substrate=substrate, config=config,
                        device=device)


def solve(A, b, method: str = "p-bicgsafe", *, x0=None, tol=None,
          maxiter=None, r0_star=None, precond=None,
          substrate: SubstrateLike = "torch",
          config: SolverConfig = SolverConfig(),
          device=None) -> SolveResult:
    """One-shot convenience: ``repro_torch.solve(A, b)``."""
    session = make_solver(method, A, precond=precond, substrate=substrate,
                          config=config, device=device)
    return session.solve(b, x0, tol=tol, maxiter=maxiter, r0_star=r0_star)
