"""BiCGStab (van der Vorst 1992; paper Alg. 2.1), parallel 2-phase form
(PyTorch port of ``repro.core.bicgstab``).

Two reductions per iteration, as the paper's Fig. 3.1 draws it: the
textbook listing's third reduction, ``(r0*, r_{i+1})`` and
``||r_{i+1}||``, is folded into phase 2 through

    (r0*, r_{i+1}) = (r0*, t) - omega (r0*, At)
    ||r_{i+1}||^2  = (t,t) - 2 omega (At,t) + omega^2 (At,At)

Plain PyTorch on either substrate (no kernel of its own; the ``"cuda"``
substrate sends an ELL operator's matvec to the SpMV kernel).  It is the
guarded driver's default method fallback
(:class:`repro_torch.resilience.RecoveryPolicy`).

The loop is :func:`repro_torch.core.pipelined_bicgsafe.run_chunked`:
steps queued by the host in chunks of ``CHUNK`` (a CUDA graph replay each
on the card), one host read of the stop flag per chunk, and a state that
has stopped carried unchanged.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..precond.base import PrecondLike
from ._common import (hold_checked, init_guess, recurred_result,
                      safe_div)
from .pipelined_bicgsafe import ChunkedMethod, solve_chunked
from .substrate import SubstrateLike
from .types import SolveResult, SolverConfig, history_init, history_update


def _init(matvec, b, x0, r0_star, config: SolverConfig, sub):
    x = init_guess(b, x0)
    r0 = b - matvec(x) if x0 is not None else b
    rs = r0 if r0_star is None else r0_star.to(b.dtype)

    init = sub.dots([(r0, r0), (rs, r0)])
    norm_r0 = torch.sqrt(init[0])
    # ||r_0|| == 0 (zero rhs, or exact initial guess): converge at t=0
    # instead of dividing by zero in the relres checks
    conv0 = norm_r0 == 0
    norm_r0 = torch.where(conv0, torch.ones_like(norm_r0), norm_r0)
    false = torch.zeros((), dtype=torch.bool, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    state = dict(
        x=x, r=r0, p=r0, ap=torch.zeros_like(b),
        rho=init[1], alpha=one, omega=one,
        rr=init[0],                      # ||r_i||^2 (recurred)
        i=torch.zeros((), dtype=torch.int32, device=b.device),
        relres=torch.where(conv0, 0.0, 1.0).to(norm_r0.dtype),
        converged=conv0, breakdown=false,
        hist=history_init(config, norm_r0.dtype, b.device))
    return state, dict(rs=rs, norm_r0=norm_r0, false=false)


def _step(st, c, _replace, *, matvec, sub, config: SolverConfig):
    """One iteration of the JAX loop body; a stopped state is kept."""
    eps = config.breakdown_threshold(st["x"].dtype)
    rs = c["rs"]
    active = ~st["converged"] & ~st["breakdown"]
    relres = torch.sqrt(torch.abs(st["rr"])) / c["norm_r0"]
    done = relres <= config.tol
    hist = history_update(st["hist"], st["i"], relres, config, active)

    r, p = st["r"], st["p"]
    ap = matvec(p)
    d1 = sub.dots([(rs, ap)])                           # phase 1: (r0*, Ap)
    alpha, bad1 = safe_div(st["rho"], d1[0], eps)
    t = r - alpha * ap
    at = matvec(t)
    d2 = sub.dots([(at, t), (at, at), (rs, t), (rs, at), (t, t)])
    omega, bad2 = safe_div(d2[0], d2[1], eps)           # phase 2: 5 dots
    rho_next = d2[2] - omega * d2[3]
    rr_next = d2[4] - 2.0 * omega * d2[0] + omega * omega * d2[1]
    beta, bad3 = safe_div(rho_next * alpha, st["rho"] * omega, eps)

    x_next = st["x"] + alpha * p + omega * t
    r_next = t - omega * at
    new = dict(
        x=x_next, r=r_next, p=r_next + beta * (p - omega * ap), ap=ap,
        rho=rho_next, alpha=alpha, omega=omega, rr=rr_next,
        i=st["i"] + 1, relres=relres, converged=c["false"],
        breakdown=bad1 | bad2 | bad3, hist=hist)
    return hold_checked(st, new, active, relres, done, hist)


def _result(st, c, config: SolverConfig) -> SolveResult:
    return recurred_result(st, c["norm_r0"], config.tol)


BICGSTAB = ChunkedMethod(_init, _step, _result)


def bicgstab_solve(matvec: Callable,
                   b: torch.Tensor,
                   x0: Optional[torch.Tensor] = None,
                   *,
                   config: SolverConfig = SolverConfig(),
                   r0_star: Optional[torch.Tensor] = None,
                   substrate: SubstrateLike = "torch",
                   precond: PrecondLike = None,
                   stats: Optional[Dict[str, int]] = None) -> SolveResult:
    """Solve A x = b with BiCGStab.

    ``matvec`` is a callable or an operator (dispatched through the
    substrate).  ``precond`` (a name or a :class:`repro_torch.precond
    .Preconditioner`) runs the left-preconditioned system M^{-1} A x =
    M^{-1} b; ``relres``/``tol`` are then in the preconditioned norm.
    ``stats``, when given, accumulates ``steps`` (iterations queued,
    stopped ones included) and ``host_reads``.
    """
    return solve_chunked(BICGSTAB, matvec, b, x0, config=config,
                         r0_star=r0_star, substrate=substrate,
                         precond=precond, stats=stats)
