"""CGS — Conjugate Gradient Squared (Sonneveld 1989) (PyTorch port of
``repro.core.cgs``).

The pre-BiCGStab product-type baseline: it applies the BiCG polynomial
twice (r_i = R_i(A)^2 r_0), so it converges erratically (the squared
residual polynomial amplifies rounding).  Two reduction phases per
iteration.  Plain PyTorch on either substrate; the loop is
:func:`repro_torch.core.pipelined_bicgsafe.run_chunked` (a CUDA graph
replay per chunk on the card), and a step checks
the recurred ``||r_i||`` it was given, as the JAX body does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..precond.base import PrecondLike
from ._common import (hold_checked, init_guess, recurred_result,
                      safe_div, tol_const)
from .pipelined_bicgsafe import ChunkedMethod, solve_chunked
from .substrate import SubstrateLike
from .types import (DotReduce, SolveResult, SolverConfig, history_init,
                    history_update)


def _init(matvec, b, x0, r0_star, config: SolverConfig, sub, reduce):
    x = init_guess(b, x0)
    r0 = b - matvec(x) if x0 is not None else b
    rs = r0 if r0_star is None else r0_star.to(b.dtype)

    init = reduce(sub.dots([(r0, r0), (rs, r0)]))
    norm_r0 = torch.sqrt(init[0])
    # ||r_0|| == 0: converge at t=0 instead of dividing by zero
    conv0 = norm_r0 == 0
    norm_r0 = torch.where(conv0, torch.ones_like(norm_r0), norm_r0)
    false = torch.zeros((), dtype=torch.bool, device=b.device)
    state = dict(
        x=x, r=r0, p=r0, u=r0, q=torch.zeros_like(b),
        rho=init[1], rr=init[0],
        i=torch.zeros((), dtype=torch.int32, device=b.device),
        relres=torch.where(conv0, 0.0, 1.0).to(norm_r0.dtype),
        converged=conv0, breakdown=false,
        hist=history_init(config, norm_r0.dtype, b.device))
    return state, dict(rs=rs, norm_r0=norm_r0, false=false,
                       tol=tol_const(config, norm_r0))


def _step(st, c, _replace, *, matvec, sub, config: SolverConfig, reduce):
    """One iteration of the JAX loop body; a stopped state is kept."""
    eps = config.breakdown_threshold(st["x"].dtype)
    rs = c["rs"]
    active = ~st["converged"] & ~st["breakdown"]
    relres = torch.sqrt(torch.abs(st["rr"])) / c["norm_r0"]
    done = relres <= c["tol"]
    hist = history_update(st["hist"], st["i"], relres, config, active)

    p, u, r = st["p"], st["u"], st["r"]
    vp = matvec(p)
    d1 = reduce(sub.dots([(rs, vp)]))                 # phase 1
    alpha, bad1 = safe_div(st["rho"], d1[0], eps)
    q = u - alpha * vp
    uq = u + q
    x_next = st["x"] + alpha * uq
    r_next = r - alpha * matvec(uq)
    d2 = reduce(sub.dots([(rs, r_next), (r_next, r_next)]))   # phase 2
    rho_next = d2[0]
    beta, bad2 = safe_div(rho_next, st["rho"], eps)
    u_next = r_next + beta * q
    p_next = u_next + beta * (q + beta * p)

    new = dict(
        x=x_next, r=r_next, p=p_next, u=u_next, q=q,
        rho=rho_next, rr=d2[1], i=st["i"] + 1, relres=relres,
        converged=c["false"], breakdown=bad1 | bad2, hist=hist)
    return hold_checked(st, new, active, relres, done, hist)


def _result(st, c, config: SolverConfig) -> SolveResult:
    return recurred_result(st, c["norm_r0"], c["tol"])


CGS = ChunkedMethod(_init, _step, _result)


def cgs_solve(matvec: Callable,
              b: torch.Tensor,
              x0: Optional[torch.Tensor] = None,
              *,
              config: SolverConfig = SolverConfig(),
              r0_star: Optional[torch.Tensor] = None,
              substrate: SubstrateLike = "torch",
              precond: PrecondLike = None,
              dot_reduce: Optional[DotReduce] = None,
              stats: Optional[Dict[str, int]] = None) -> SolveResult:
    """Solve A x = b with CGS (left-preconditioned when ``precond`` is
    set).  Arguments as in :func:`repro_torch.core.bicgstab
    .bicgstab_solve`."""
    return solve_chunked(CGS, matvec, b, x0, config=config,
                         r0_star=r0_star, substrate=substrate,
                         precond=precond, dot_reduce=dot_reduce,
                         stats=stats)
