"""GuardedSolver: chunked guarded solves with recovery (PyTorch port of
``repro.resilience.guard``).

The driver between the device-side health rows of
:mod:`repro_torch.core.multirhs` (``SolverConfig.guard``: the fused
reduction widened from (9, m) to (11, m), still one reduction and still no
edge to the in-flight matvec) and the host-side
:class:`~repro_torch.resilience.RecoveryPolicy`:

1. step the guarded state in chunks of ``policy.chunk`` iterations through
   a bound :class:`repro_torch.api.LinearSolver` session (its
   ``step_chunk`` program: a CUDA graph replay per chunk on the card);
2. read the (m,) health flags at each chunk boundary: the nine flags are
   stacked on the device and copied to the host in ONE transfer, counted
   in the session's ``stats["host_reads"]``;
3. apply the policy: residual replacement for drifted columns, restart
   from the current x for broken-down, non-finite or stagnant ones,
   substrate degradation (``"cuda"`` -> ``"torch"``, on the same device,
   from the same state) after a :class:`~repro_torch.resilience
   .SimulatedKernelFailure`, and a per-column method fallback once
   restarts are used up.  Any other error (a failed build, a CUDA error)
   is raised: the port never runs the plain version in place of a
   kernel, and after a CUDA error the device's context is lost anyway.

Under ``precond=`` the state is the left-preconditioned system's, so the
recovery steps recompute true residuals against ``M^{-1} B``, and the
degraded and fallback sessions carry the session's preconditioner.

Every action is logged in ``events`` and counted in the state
(``replacements`` / ``restarts`` per column).  A clean solve takes the
unguarded numerical path: the health rows only observe.

Build one with ``repro_torch.make_solver(..., recovery=RecoveryPolicy())``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import numpy as np
import torch

from .. import api
from ..core.types import SolveResult, SolveStatus, SolverConfig, per_column
from .inject import SimulatedKernelFailure
from .policy import RecoveryPolicy
from .recover import replace_columns, restart_columns

#: statuses a restart from the current x may answer
_RESTARTABLE = np.array([SolveStatus.BREAKDOWN.value,
                         SolveStatus.BREAKDOWN_RHO.value,
                         SolveStatus.BREAKDOWN_ALPHA.value,
                         SolveStatus.BREAKDOWN_OMEGA.value,
                         SolveStatus.NONFINITE.value], np.int32)

#: the per-column flags read at every chunk boundary, in one transfer
_FLAGS = ("status", "converged", "breakdown", "iterations", "col_maxiter",
          "drift_flag", "stagnant", "replacements", "restarts")


def _stamp_stagnation(state: dict, mask: torch.Tensor) -> dict:
    """Freeze the columns whose stagnation outlived the restart budget:
    typed STAGNATION, frozen as a breakdown so no chunk runs them on."""
    out = dict(state)
    out["breakdown"] = state["breakdown"] | mask
    out["status"] = torch.where(mask, SolveStatus.STAGNATION.value,
                                state["status"]).to(torch.int32)
    return out


class GuardedSolver:
    """A p-BiCGSafe session wrapped with breakdown detection and recovery.

    It has the solve surface of :class:`repro_torch.api.LinearSolver`
    (``solve`` / ``solve_many``); every result carries typed per-column
    :class:`~repro_torch.core.SolveStatus` codes, and ``x`` is finite
    (a failed column is set to 0 where it is not, never NaN).

    Attributes:
      session: the inner guarded session (``config.guard`` is set).
      policy: the bound :class:`RecoveryPolicy`.
      events: the log of recovery actions, one dict each (replace /
        restart / substrate_degraded / method_fallback /
        stagnation_giveup), accumulated across solves.
      inject: an optional hook ``(chunk_index, state) -> state`` run before
        each chunk (see :class:`~repro_torch.resilience.ChunkFaultInjector`);
        it may raise :class:`~repro_torch.resilience.SimulatedKernelFailure`
        to simulate a kernel failure.
      stats: the inner session's counters (``steps``, ``host_reads``, ...);
        a degraded session goes on counting into the same dict.
    """

    def __init__(self, session, policy: RecoveryPolicy = RecoveryPolicy(),
                 *, inject=None):
        if session.method != "p-bicgsafe":
            raise ValueError(
                "GuardedSolver drives the batched guarded p-BiCGSafe "
                f"iteration (got a {session.method!r} session); "
                "method fallbacks are where other methods come in")
        if not session.config.guard:
            raise ValueError(
                "GuardedSolver needs a guarded session "
                "(SolverConfig.guard=True; make_solver(recovery=...) "
                "sets this up)")
        self.session = session
        self.policy = policy
        self.events: List[Dict[str, Any]] = []
        self.inject = inject
        self._active = session          # degrades to a "torch" session

    @property
    def config(self) -> SolverConfig:
        return self.session.config

    @property
    def stats(self) -> Dict[str, int]:
        return self.session.stats

    def solve(self, b, x0=None, *, tol=None, maxiter=None,
              r0_star=None) -> SolveResult:
        """Guarded single-RHS solve: the m = 1 batched guarded iteration,
        with the result's fields taken out of their column."""
        sess = self.session
        X0 = None if x0 is None else sess._tensor(x0)[:, None]
        rs = None if r0_star is None else sess._tensor(r0_star)[:, None]
        res = self.solve_many(sess._tensor(b)[:, None], X0, tol=tol,
                              maxiter=maxiter, r0_star=rs)
        hist = res.residual_history
        if hist.dim() == 2:
            hist = hist[:, 0]
        return SolveResult(res.x[:, 0], res.iterations[0], res.relres[0],
                           res.converged[0], res.breakdown[0], hist,
                           res.status[0], None)

    def solve_many(self, B, X0=None, *, tol=None, maxiter=None,
                   r0_star=None) -> SolveResult:
        """Guarded multi-RHS solve with the policy's recovery.  A clean
        solve is the unguarded ``session.solve_many`` numerically; the
        result differs in its typed statuses and in surviving faults."""
        sess = self.session
        B = sess._as_block(B)
        n, m = B.shape
        cfg = sess.config
        tol_col = per_column(cfg.tol if tol is None else tol, m, B.dtype,
                             name="tol", device="cpu")
        mit_col = per_column(cfg.maxiter if maxiter is None else maxiter, m,
                             torch.int32, name="maxiter", device="cpu")
        state = self._active.init(B, X0, tol=tol_col.to(B.device),
                                  maxiter=mit_col.to(B.device),
                                  r0_star=r0_star)
        # the right-hand sides the recovery steps recompute true residuals
        # against: M^{-1} B under preconditioning, as the state's r is
        # (the state does not carry them)
        Bp = self._active._prep(B)

        pol = self.policy
        chunk = pol.chunk
        budget = int(mit_col.max()) if m else 0
        # total-work bound: every restart refunds a column's budget, so the
        # loop is capped at (1 + max_restarts) budgets, plus a chunk
        max_chunks = (1 + pol.max_restarts) * math.ceil(
            max(budget, 1) / chunk) + 1

        ci = 0
        degraded_once = False
        while ci < max_chunks:
            try:
                st = state
                if self.inject is not None:
                    st = self.inject(ci, st)
                state = self._active.step_chunk(st, chunk)
            except SimulatedKernelFailure as exc:
                if degraded_once or not self.policy.substrate_fallback:
                    raise
                self._degrade(exc, ci)
                degraded_once = True
                continue            # retry the same chunk, degraded
            ci += 1

            self.stats["host_reads"] += 1
            f = dict(zip(_FLAGS, torch.stack(
                [state[k].to(torch.int32) for k in _FLAGS]).cpu().numpy()))
            conv, brk = f["converged"] != 0, f["breakdown"] != 0
            drift_flag, stagnant = f["drift_flag"] != 0, f["stagnant"] != 0
            active = ~conv & ~brk & (f["iterations"] < f["col_maxiter"])

            need_restart = (np.isin(f["status"], _RESTARTABLE)
                            | (stagnant & active)) \
                & ~conv & (f["restarts"] < pol.max_restarts)
            need_replace = drift_flag & active & ~need_restart \
                & (f["replacements"] < pol.max_replacements)
            give_up = stagnant & active & ~need_restart

            acted = False
            bmv = self._active.block_matvec
            if need_replace.any():
                state = replace_columns(bmv, state, self._mask(need_replace),
                                        Bp)
                self._log("replace", ci, need_replace)
                acted = True
            if need_restart.any():
                state = restart_columns(bmv, state, self._mask(need_restart),
                                        Bp)
                self._log("restart", ci, need_restart)
                acted = True
            if give_up.any():
                state = _stamp_stagnation(state, self._mask(give_up))
                self._log("stagnation_giveup", ci, give_up)
                active = active & ~give_up
            if not acted and not active.any():
                break

        res = self._active.result(state)
        return self._finalize(res, B, tol_col, mit_col)

    # -- internals ------------------------------------------------------------

    def _mask(self, cols: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(cols).to(self.session.device)

    def _log(self, event: str, chunk: int, mask_or_info) -> None:
        if isinstance(mask_or_info, np.ndarray):
            cols = [int(j) for j in np.nonzero(mask_or_info)[0]]
            self.events.append(dict(event=event, chunk=chunk, columns=cols))
        else:
            self.events.append(dict(event=event, chunk=chunk,
                                    detail=mask_or_info))

    def _degrade(self, exc: SimulatedKernelFailure, chunk: int) -> None:
        """A simulated kernel failure: rebuild the session on ``"torch"`` on
        the same device and go on from the same state (a dict of tensors,
        the same on either substrate).  The degraded session counts into
        the guarded session's ``stats``, so it is this driver's own: built
        directly, never taken from or put into the session cache."""
        sess = self.session
        self._active = api.LinearSolver(sess.method, sess.operator,
                                        precond=sess.precond,
                                        substrate="torch",
                                        config=sess.config,
                                        device=sess.device)
        self._active.stats = sess.stats
        self._log("substrate_degraded", chunk,
                  dict(error=repr(exc), to="torch"))

    def _finalize(self, res: SolveResult, B: torch.Tensor,
                  tol_col: torch.Tensor, mit_col: torch.Tensor
                  ) -> SolveResult:
        """Method fallback for the columns that used up their recovery,
        then the finite-output guarantee (a failed column never returns
        NaN)."""
        pol = self.policy
        status = res.status.cpu().numpy().copy()
        failed = np.array([SolveStatus(int(s)).is_failure for s in status],
                          dtype=bool)
        x, iters, relres = res.x.clone(), res.iterations.clone(), \
            res.relres.clone()
        conv, brk = res.converged.clone(), res.breakdown.clone()

        if failed.any() and pol.method_fallback is not None:
            sess = self.session
            fb = api.make_solver(
                pol.method_fallback, sess.operator,
                precond=sess.precond, substrate="torch",
                config=dataclasses.replace(
                    sess.config, guard=False, stagnation_window=0,
                    drift_scale=0.0),
                device=sess.device)
            for j in np.nonzero(failed)[0]:
                x0j = x[:, j].contiguous()
                if not bool(torch.isfinite(x0j).all()):
                    x0j = None
                r = fb.solve(B[:, j].contiguous(), x0j,
                             tol=float(tol_col[j]), maxiter=int(mit_col[j]))
                ok = bool(r.converged)
                self.events.append(dict(
                    event="method_fallback", column=int(j),
                    method=pol.method_fallback,
                    from_status=SolveStatus(int(status[j])).name,
                    converged=ok))
                iters[j] += r.iterations.to(iters.dtype)
                if ok:
                    x[:, j] = r.x
                    relres[j] = r.relres.to(relres.dtype)
                    conv[j] = True
                    brk[j] = False
                    status[j] = SolveStatus.CONVERGED.value

        # finite-output guarantee: x never carries NaN/Inf out of here
        bad = ~torch.isfinite(x)
        if bool(bad.any()):
            x = torch.where(bad, torch.zeros_like(x), x)
            relres = torch.where(torch.isfinite(relres), relres,
                                 torch.full_like(relres, float("inf")))
        return SolveResult(x, iters, relres, conv, brk, res.residual_history,
                           torch.as_tensor(status.astype(np.int32),
                                           device=x.device), None)


def guarded_config(config: SolverConfig,
                   policy: RecoveryPolicy) -> SolverConfig:
    """The inner session's config for a policy: guard on, the monitors'
    windows forwarded."""
    return dataclasses.replace(
        config, guard=True, stagnation_window=policy.stagnation_window,
        drift_scale=policy.drift_scale)
