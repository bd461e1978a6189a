"""repro_torch.api — the front door: bind-once ``LinearSolver`` sessions
(PyTorch port of ``repro.api``).

    import repro_torch

    solver = repro_torch.make_solver("p-bicgsafe", op, substrate="cuda")
    res = solver.solve(b)                   # on the card
    many = solver.solve_many(B)             # B (n, m): all columns at once
    res = repro_torch.solve(op, b)          # one-shot

    st = solver.init(B, tol=1e-6)           # open loop, what a service drives
    st = solver.step_chunk(st, 16)
    st = solver.splice(st, refill, B_new)   # refill finished columns
    res = solver.result(st)

    guarded = repro_torch.make_solver("p-bicgsafe", op, substrate="cuda",
                                      recovery=RecoveryPolicy(chunk=16))
    res = guarded.solve_many(B)             # typed statuses, recovery

``device=None`` means ``"cuda"``, and raises when no GPU is present: pass
``device="cpu"`` to run on the CPU.  The operator's tensors must lie on the
session's device.

    pre = repro_torch.make_solver("p-bicgsafe", op, substrate="cuda",
                                  precond="block_jacobi")
    res = pre.solve(b)                      # M^{-1} A x = M^{-1} b

``precond=`` (``None``, a name of :data:`repro_torch.precond
.PRECONDITIONERS` or a :class:`repro_torch.precond.Preconditioner`) is
checked when the session is made and built on first use, once; every
solve of the session, single, batched and open-loop, then runs on the
left-preconditioned system, whose residual ``relres``/``tol`` measure.

Not ported yet, and raising :class:`NotImplementedError`: ``trace=`` and
``profile=`` of ``solve`` and ``solve_many``, and ``on_mesh``.  Sessions
are not cached by operator content (the JAX package's
``operator_fingerprint``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .core import SOLVERS, multirhs
from .core.substrate import SubstrateLike, get_substrate
from .core.types import SolveResult, SolverConfig, resolve_device
from .precond.base import (PrecondLike, Preconditioner, resolve_precond,
                           validate_precond_spec)

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
      precond_spec: the ``precond=`` spec as given; ``precond`` the built
        preconditioner (``None`` when unset), built on first access.
      block_matvec: the substrate's ``(n, m)`` block matvec of the operator
        (the block ELL kernel on ``"cuda"``), composed once with the bound
        M^{-1}-apply when there is a preconditioner.
      stats: ``{"solves", "steps", "rr_steps", "host_reads"}`` summed over
        this session's solves and open-loop chunks: iterations queued
        (stopped ones included), residual-replacement steps and host reads
        of the stop flag.
    """

    def __init__(self, method: str, operator, *,
                 precond: PrecondLike = None,
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
        # checked now (a bad spec fails at make_solver), built on first use:
        # a block-Jacobi build at full size takes seconds
        validate_precond_spec(precond, operator)
        self.precond_spec = precond
        self._precond_built = False
        self._precond: Optional[Preconditioner] = None
        self._bmv: Optional[Callable] = None
        self._papply: Optional[Callable] = None
        self.stats: Dict[str, int] = {"solves": 0, "steps": 0,
                                      "rr_steps": 0, "host_reads": 0}

    @property
    def precond(self) -> Optional[Preconditioner]:
        """The built preconditioner (the first access builds it, once)."""
        if not self._precond_built:
            self._precond = resolve_precond(self.precond_spec, self.operator)
            self._precond_built = True
        return self._precond

    @property
    def block_matvec(self) -> Callable:
        """The substrate's block matvec, composed once with M^{-1}."""
        if self._bmv is None:
            raw = self.sub.as_block_matvec(self.operator)
            pc = self.precond
            if pc is None:
                self._bmv = raw
            else:
                papply = self.sub.as_precond_apply(pc)
                self._papply = papply
                self._bmv = lambda X: papply(raw(X))
        return self._bmv

    def _prep(self, B: torch.Tensor) -> torch.Tensor:
        """``M^{-1} B``: the right-hand sides of the preconditioned system
        (``B`` itself without a preconditioner)."""
        self.block_matvec                 # composes, and binds the apply
        return B if self._papply is None else self._papply(B)

    def __repr__(self):
        # the spec, not the property: a repr must not trigger the build
        pc = getattr(self._precond, "name", None) if self._precond_built \
            else self.precond_spec
        return (f"<LinearSolver {self.method!r} substrate={self.sub.name!r} "
                f"precond={pc!r} device={str(self.device)!r}>")

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
            precond=self.precond, stats=self.stats)

    # -- multi-RHS and the open-loop handles -------------------------------

    def _require_pbicgsafe(self, what: str) -> None:
        """The batched iteration is p-BiCGSafe: a session bound to another
        method must not run it under its own name."""
        if self.method != "p-bicgsafe":
            raise ValueError(
                f"{what} runs the batched p-BiCGSafe iteration only (this "
                f"session is bound to {self.method!r}); bind a "
                '"p-bicgsafe" session for multi-RHS / open-loop solves, or '
                "use .solve per right-hand side")

    def _as_block(self, B) -> torch.Tensor:
        """An (n, m) block, or a sequence of (n,) columns, as a contiguous
        (n, m) tensor on the session's device."""
        if isinstance(B, (list, tuple)):
            B = torch.stack([self._tensor(c) for c in B], dim=1)
        else:
            B = self._tensor(B)
        if B.dim() != 2:
            raise ValueError(f"B must be (n, m) or a sequence of (n,) "
                             f"columns; got shape {tuple(B.shape)}")
        return B.contiguous()

    def solve_many(self, B, X0=None, *, tol=None, maxiter=None,
                   r0_star=None, trace=None, profile=None) -> SolveResult:
        """Solve A X = B for all columns at once: one (9, m) reduction per
        iteration.  ``B`` is (n, m) or a sequence of (n,) columns; ``tol``
        and ``maxiter`` are scalars or (m,).  A scalar ``maxiter`` also
        bounds the loop; (m,) budgets are capped by ``config.maxiter``.
        The result's fields are per column (see :func:`repro_torch.core
        .multirhs.result_from_state`)."""
        self._require_pbicgsafe("solve_many")
        if trace:
            raise _not_ported("solve_many(trace=...)")
        if profile is not None:
            raise _not_ported("solve_many(profile=...)")
        B = self._as_block(B)
        if maxiter is not None and np.ndim(maxiter) == 0:
            cfg, maxiter = self._derive(None, maxiter), None
        else:
            cfg = self.config
        self.stats["solves"] += 1
        st = multirhs.init_state(
            self.block_matvec, self._prep(B), self._tensor(X0), config=cfg,
            r0_star=self._tensor(r0_star), substrate=self.sub, tol=tol,
            maxiter=maxiter)
        st = multirhs.step_chunk(self.block_matvec, st, cfg.maxiter,
                                 config=cfg, substrate=self.sub,
                                 stats=self.stats)
        return multirhs.result_from_state(st)

    def init(self, B, X0=None, *, tol=None, maxiter=None,
             r0_star=None) -> dict:
        """The per-column Krylov state for ``A X = B`` (open loop)."""
        self._require_pbicgsafe("init")
        return multirhs.init_state(
            self.block_matvec, self._prep(self._as_block(B)),
            self._tensor(X0),
            config=self.config, r0_star=self._tensor(r0_star),
            substrate=self.sub, tol=tol, maxiter=maxiter)

    def step_chunk(self, state: dict, k: int) -> dict:
        """Advance every live column by up to ``k`` iterations."""
        self._require_pbicgsafe("step_chunk")
        return multirhs.step_chunk(self.block_matvec, state, int(k),
                                   config=self.config, substrate=self.sub,
                                   stats=self.stats)

    def splice(self, state: dict, refill, B_new, *, tol=None, maxiter=None,
               r0_star=None) -> dict:
        """Refill the ``refill`` columns with fresh right-hand sides from
        ``B_new`` mid-flight; the other columns are left untouched.  The
        fresh columns' ``tol`` / ``maxiter`` default to the bound config's."""
        self._require_pbicgsafe("splice")
        return multirhs.splice_columns(
            self.block_matvec, state, self._tensor(refill),
            self._prep(self._as_block(B_new)), r0_star=self._tensor(r0_star),
            substrate=self.sub,
            tol=self.config.tol if tol is None else tol,
            maxiter=self.config.maxiter if maxiter is None else maxiter)

    def splice_step(self, state: dict, refill, B_new, tol, maxiter,
                    k: int) -> dict:
        """:meth:`splice`, then :meth:`step_chunk` of ``k``."""
        self._require_pbicgsafe("splice_step")
        state = self.splice(state, refill, B_new, tol=tol, maxiter=maxiter)
        return self.step_chunk(state, k)

    def result(self, state: dict) -> SolveResult:
        """Package an open-loop state as a :class:`SolveResult`."""
        return multirhs.result_from_state(state)

    def on_mesh(self, *args, **kwargs):
        raise _not_ported("on_mesh (distributed solves)")


def make_solver(method: str = "p-bicgsafe", operator=None, *,
                precond: PrecondLike = None,
                substrate: SubstrateLike = "torch",
                config: SolverConfig = SolverConfig(),
                device=None,
                recovery=None):
    """Bind ``method`` (a name from :data:`repro_torch.core.SOLVERS`) to
    ``operator`` (Dense/CSR/ELL/Stencil7, a dense matrix, or a matvec
    callable) on ``device`` (``None`` means ``"cuda"``).

    ``precond``: ``None``, a name of :data:`repro_torch.precond
    .PRECONDITIONERS` (built from ``operator``, which must then be an
    operator object) or a :class:`repro_torch.precond.Preconditioner`;
    checked here, built on first use, once.  Every solve of the session
    runs on the left-preconditioned system.

    ``recovery``: ``None`` | ``True`` | a :class:`repro_torch.resilience
    .RecoveryPolicy`.  Given one, the result is a :class:`repro_torch
    .resilience.GuardedSolver` around a guarded session (``config.guard``:
    the fused reduction widens to (11, m) health rows) whose chunked
    driver applies the policy; ``True`` means the default policy.
    p-BiCGSafe only."""
    if operator is None:
        raise TypeError("make_solver requires an operator")
    if recovery is not None and recovery is not False:
        # lazy: repro_torch.resilience imports this module for fallbacks
        from .resilience.guard import GuardedSolver, guarded_config
        from .resilience.policy import RecoveryPolicy
        policy = RecoveryPolicy() if recovery is True else recovery
        if not isinstance(policy, RecoveryPolicy):
            raise TypeError(
                f"recovery must be None, True or a RecoveryPolicy; got "
                f"{type(recovery).__name__}")
        inner = make_solver(method, operator, precond=precond,
                            substrate=substrate,
                            config=guarded_config(config, policy),
                            device=device)
        return GuardedSolver(inner, policy)
    return LinearSolver(method, operator, precond=precond,
                        substrate=substrate, config=config, device=device)


def solve(A, b, method: str = "p-bicgsafe", *, x0=None, tol=None,
          maxiter=None, r0_star=None, precond: PrecondLike = None,
          substrate: SubstrateLike = "torch",
          config: SolverConfig = SolverConfig(),
          device=None) -> SolveResult:
    """One-shot convenience: ``repro_torch.solve(A, b)`` (``precond=`` as
    in :func:`make_solver`)."""
    session = make_solver(method, A, precond=precond, substrate=substrate,
                          config=config, device=device)
    return session.solve(b, x0, tol=tol, maxiter=maxiter, r0_star=r0_star)
