"""ssBiCGSafe2 — single-synchronisation BiCGSafe (paper Alg. 2.3, Fujino)
(PyTorch port of ``repro.core.ssbicgsafe``).

The non-pipelined baseline: one reduction phase per iteration, the fused
9 dots of p-BiCGSafe (``sub.bicgsafe_dots``, the ``fused_dots`` kernel on
``"cuda"``), but they *read* the fresh matvec ``s_i = A r_i``, so the
reduction cannot overlap with it.  Two matvecs per iteration (``A r_i``,
``A u_i``); the vector updates are plain PyTorch, as in the JAX package.

The loop is :func:`repro_torch.core.pipelined_bicgsafe.run_chunked`: steps
queued by the host in chunks (a CUDA graph replay each on the card), one
host read of the stop flag per chunk,
and a state that has stopped carried unchanged.  As in the JAX package the
stop is decided inside a step, from that step's dots: the step that finds
convergence (or a breakdown) keeps the state it was given.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..precond.base import PrecondLike
from ._common import (bicgsafe_coefficients, hold_in_step, init_guess,
                      state_result)
from .pipelined_bicgsafe import ChunkedMethod, solve_chunked
from .substrate import SubstrateLike
from .types import SolveResult, SolverConfig, history_init, history_update


def _init(matvec, b, x0, r0_star, config: SolverConfig, sub):
    x = init_guess(b, x0)
    r0 = b - matvec(x) if x0 is not None else b
    rs = r0 if r0_star is None else r0_star.to(b.dtype)

    norm_r0 = torch.sqrt(sub.dots([(r0, r0)])[0])
    # ||r_0|| == 0: converge at t=0 instead of dividing by zero
    conv0 = norm_r0 == 0
    norm_r0 = torch.where(conv0, torch.ones_like(norm_r0), norm_r0)
    z0 = torch.zeros_like(b)
    i0 = torch.zeros((), dtype=torch.int32, device=b.device)
    false = torch.zeros((), dtype=torch.bool, device=b.device)
    hist = history_update(history_init(config, norm_r0.dtype, b.device), i0,
                          torch.ones_like(norm_r0), config, ~false)

    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    state = dict(
        x=x, r=r0, p=z0, u=z0, t=z0, y=z0, z=z0,
        alpha=zero, zeta=one, f=one, i=i0,
        relres=torch.where(conv0, 0.0, 1.0).to(norm_r0.dtype),
        converged=conv0, breakdown=false, hist=hist)
    return state, dict(rs=rs, norm_r0=norm_r0, false=false)


def _step(st, c, _replace, *, matvec, sub, config: SolverConfig):
    """One iteration of the JAX loop body; a stopped state is kept."""
    eps = config.breakdown_threshold(st["x"].dtype)
    active = ~st["converged"] & ~st["breakdown"]
    r, y, t_prev = st["r"], st["y"], st["t"]
    s = matvec(r)                                       # MV #1: s_i = A r_i
    # the single fused reduction phase reads s: no overlap with MV #1
    dots = sub.bicgsafe_dots(s, y, r, t_prev, c["rs"])
    beta, alpha, zeta, eta, f, rr, bad = bicgsafe_coefficients(
        dots, st["i"], st["alpha"], st["zeta"], st["f"], eps)
    relres = torch.sqrt(torch.abs(rr)) / c["norm_r0"]
    done = relres <= config.tol

    # vector updates (paper lines 23-30)
    p = r + beta * (st["p"] - st["u"])
    o = s + beta * t_prev
    u = zeta * o + eta * (y + beta * st["u"])
    w = matvec(u)                                       # MV #2: w_i = A u_i
    t = o - w
    z = zeta * r + eta * st["z"] - alpha * u
    y_next = zeta * s + eta * y - alpha * w
    x_next = st["x"] + alpha * p + z
    r_next = r - alpha * o - y_next

    hist_i = history_update(st["hist"], st["i"], relres, config, active)
    false = c["false"]
    new = dict(
        x=x_next, r=r_next, p=p, u=u, t=t, y=y_next, z=z,
        alpha=alpha, zeta=zeta, f=f, i=st["i"] + 1, relres=relres,
        converged=false, breakdown=false, hist=hist_i)
    return hold_in_step(st, new, active, relres, done, bad, hist_i)


def _result(st, c, config: SolverConfig) -> SolveResult:
    return state_result(st)


SSBICGSAFE2 = ChunkedMethod(_init, _step, _result)


def ssbicgsafe2_solve(matvec: Callable,
                      b: torch.Tensor,
                      x0: Optional[torch.Tensor] = None,
                      *,
                      config: SolverConfig = SolverConfig(),
                      r0_star: Optional[torch.Tensor] = None,
                      substrate: SubstrateLike = "torch",
                      precond: PrecondLike = None,
                      stats: Optional[Dict[str, int]] = None) -> SolveResult:
    """Solve A x = b with ssBiCGSafe2 (Alg. 2.3; left-preconditioned when
    ``precond`` is set).  Arguments as in :func:`repro_torch.core
    .bicgstab.bicgstab_solve`."""
    return solve_chunked(SSBICGSAFE2, matvec, b, x0, config=config,
                         r0_star=r0_star, substrate=substrate,
                         precond=precond, stats=stats)
