"""GPBi-CG (Zhang 1997; paper Alg. 2.2) (PyTorch port of
``repro.core.gpbicg``).

Generalized product-type method: a three-term stabilizing polynomial with
coefficients (zeta, eta) minimizing ||t - eta*y - zeta*A t||.  Three
reduction phases per iteration (paper Fig. 3.1): the convergence baseline
that BiCGSafe improves upon.  Plain PyTorch on either substrate; the loop
is :func:`repro_torch.core.pipelined_bicgsafe.run_chunked` (a CUDA graph
replay per chunk on the card), and a step
checks the recurred ``||r_i||`` it was given, as the JAX body does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..precond.base import PrecondLike
from ._common import (_first, hold_checked, init_guess, recurred_result,
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
    z0 = torch.zeros_like(b)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    false = torch.zeros((), dtype=torch.bool, device=b.device)
    state = dict(
        x=x, r=r0, p=z0, u=z0, t=z0, w=z0, z=z0,
        rho=init[1],                       # (r0*, r_i)
        beta=zero, zeta=torch.ones_like(zero), rr=init[0],
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

    r, beta = st["r"], st["beta"]
    t_prev, w_prev, u_prev = st["t"], st["w"], st["u"]
    # the first step's branch, decided on the device
    first = _first(st["i"], r)

    p = r + beta * (st["p"] - u_prev)                 # line 7
    ap = matvec(p)                                    # line 8
    d1 = reduce(sub.dots([(rs, ap)]))                 # phase 1: alpha
    alpha, bad1 = safe_div(st["rho"], d1[0], eps)

    y = t_prev - r - alpha * w_prev + alpha * ap      # line 10
    t = r - alpha * ap                                # line 11
    at = matvec(t)                                    # line 12
    # phase 2: a..e for (zeta, eta)
    a_, b_, c_, d_, e_ = reduce(sub.dots(
        [(y, y), (at, t), (y, t), (at, y), (at, at)])).unbind(0)
    zeta0, badz0 = safe_div(b_, e_, eps)              # line 15
    den = e_ * a_ - d_ * d_
    zeta_g, badzg = safe_div(a_ * b_ - c_ * d_, den, eps)   # line 18
    eta_g, _ = safe_div(e_ * c_ - d_ * b_, den, eps)        # line 19
    zeta = torch.where(first, zeta0, zeta_g)
    eta = torch.where(first, torch.zeros_like(zeta), eta_g)
    bad2 = torch.where(first, badz0, badzg)

    u = zeta * ap + eta * (t_prev - r + beta * u_prev)      # line 21
    z = zeta * r + eta * st["z"] - alpha * u                # line 22
    x_next = st["x"] + alpha * p + z                        # line 23
    r_next = t - eta * y - zeta * at                        # line 24
    # phase 3: beta and the residual norm
    d3 = reduce(sub.dots([(rs, r_next), (r_next, r_next)]))
    rho_next = d3[0]
    beta_next, bad3 = safe_div(alpha * rho_next, zeta * st["rho"], eps)
    w = at + beta_next * ap                                 # line 26

    new = dict(
        x=x_next, r=r_next, p=p, u=u, t=t, w=w, z=z,
        rho=rho_next, beta=beta_next, zeta=zeta, rr=d3[1],
        i=st["i"] + 1, relres=relres, converged=c["false"],
        breakdown=bad1 | bad2 | bad3, hist=hist)
    return hold_checked(st, new, active, relres, done, hist)


def _result(st, c, config: SolverConfig) -> SolveResult:
    return recurred_result(st, c["norm_r0"], c["tol"])


GPBICG = ChunkedMethod(_init, _step, _result)


def gpbicg_solve(matvec: Callable,
                 b: torch.Tensor,
                 x0: Optional[torch.Tensor] = None,
                 *,
                 config: SolverConfig = SolverConfig(),
                 r0_star: Optional[torch.Tensor] = None,
                 substrate: SubstrateLike = "torch",
                 precond: PrecondLike = None,
                 dot_reduce: Optional[DotReduce] = None,
                 stats: Optional[Dict[str, int]] = None) -> SolveResult:
    """Solve A x = b with GPBi-CG (Alg. 2.2; left-preconditioned when
    ``precond`` is set).  Arguments as in :func:`repro_torch.core
    .bicgstab.bicgstab_solve`."""
    return solve_chunked(GPBICG, matvec, b, x0, config=config,
                         r0_star=r0_star, substrate=substrate,
                         precond=precond, dot_reduce=dot_reduce,
                         stats=stats)
