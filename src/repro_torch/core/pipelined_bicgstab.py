"""p-BiCGStab — communication-hiding pipelined BiCGStab (PyTorch port of
``repro.core.pipelined_bicgstab``).

Cools & Vanroose, "The communication-hiding pipelined BiCGstab method for
the parallel solution of large unsymmetric linear systems", Parallel
Computing 65:1-20, 2017 (paper reference [10]).  Two reduction phases per
iteration, each issued beside one of the two matvecs and reading none of
its output (the Table 3.1 "diamond"):

    phase 1 {(q,y),(y,y), [(q,q) for ||r||]}   beside  v_i = A z_i
    phase 2 {(r0*,r),(r0*,w),(r0*,s),(r0*,z)}  beside  t_{i+1} = A w_{i+1}

Plain PyTorch on either substrate (the ``"cuda"`` substrate sends an ELL
operator's matvec to the SpMV kernel).  The loop is
:func:`repro_torch.core.pipelined_bicgsafe.run_chunked` (a CUDA graph
replay per chunk on the card); as in the JAX
package, a step checks the recurred ``||r_i||`` it was given, and the
final relres is derived again from the last recurred one.
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
    eps = config.breakdown_threshold(b.dtype)
    x = init_guess(b, x0)
    r0 = b - matvec(x) if x0 is not None else b
    rs = r0 if r0_star is None else r0_star.to(b.dtype)

    w0 = matvec(r0)
    t0 = matvec(w0)
    init = reduce(sub.dots([(r0, r0), (rs, r0), (rs, w0)]))
    norm_r0 = torch.sqrt(init[0])
    # ||r_0|| == 0: converge at t=0, and do not report the set-up's
    # alpha_0 = 0/0 as a breakdown of an already-solved system
    conv0 = norm_r0 == 0
    norm_r0 = torch.where(conv0, torch.ones_like(norm_r0), norm_r0)
    rho0 = init[1]
    alpha0, bad0 = safe_div(rho0, init[2], eps)

    z0 = torch.zeros_like(b)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    false = torch.zeros((), dtype=torch.bool, device=b.device)
    state = dict(
        x=x, r=r0, w=w0, t=t0, p=z0, s=z0, z=z0, v=z0,
        alpha=alpha0, beta=zero, omega=torch.ones_like(zero), rho=rho0,
        rr=init[0],
        i=torch.zeros((), dtype=torch.int32, device=b.device),
        relres=torch.where(conv0, 0.0, 1.0).to(norm_r0.dtype),
        converged=conv0, breakdown=bad0 & ~conv0,
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

    beta, omega_p, alpha = st["beta"], st["omega"], st["alpha"]
    r, w, t = st["r"], st["w"], st["t"]
    p = r + beta * (st["p"] - omega_p * st["s"])
    s = w + beta * (st["s"] - omega_p * st["z"])          # == A p
    z = t + beta * (st["z"] - omega_p * st["v"])          # == A s
    q = r - alpha * s
    y = w - alpha * z                                     # == A q

    # phase 1 beside v = A z (= A^3 p): A y is t - alpha v, so the
    # dots read none of this matvec's output; started before it, waited
    # on after it
    pending = reduce.start(sub.dots([(q, y), (y, y), (q, q)]))
    v = matvec(z)                                         # MV #1
    d1 = reduce.wait(pending)
    omega, bad1 = safe_div(d1[0], d1[1], eps)
    x_next = st["x"] + alpha * p + omega * q
    r_next = q - omega * y
    rr_next = d1[2] - 2.0 * omega * d1[0] + omega * omega * d1[1]
    w_next = y - omega * (t - alpha * v)

    # phase 2 beside t_next = A w_next, in the same way
    pending = reduce.start(
        sub.dots([(rs, r_next), (rs, w_next), (rs, s), (rs, z)]))
    t_next = matvec(w_next)                               # MV #2
    d2 = reduce.wait(pending)
    rho_next = d2[0]
    beta_next, bad2 = safe_div(alpha * rho_next, omega * st["rho"], eps)
    alpha_next, bad3 = safe_div(
        rho_next, d2[1] + beta_next * d2[2] - beta_next * omega * d2[3],
        eps)

    new = dict(
        x=x_next, r=r_next, w=w_next, t=t_next, p=p, s=s, z=z, v=v,
        alpha=alpha_next, beta=beta_next, omega=omega, rho=rho_next,
        rr=rr_next, i=st["i"] + 1, relres=relres, converged=c["false"],
        breakdown=bad1 | bad2 | bad3, hist=hist)
    return hold_checked(st, new, active, relres, done, hist)


def _result(st, c, config: SolverConfig) -> SolveResult:
    return recurred_result(st, c["norm_r0"], c["tol"])


PBICGSTAB = ChunkedMethod(_init, _step, _result)


def pbicgstab_solve(matvec: Callable,
                    b: torch.Tensor,
                    x0: Optional[torch.Tensor] = None,
                    *,
                    config: SolverConfig = SolverConfig(),
                    r0_star: Optional[torch.Tensor] = None,
                    substrate: SubstrateLike = "torch",
                    precond: PrecondLike = None,
                    dot_reduce: Optional[DotReduce] = None,
                    stats: Optional[Dict[str, int]] = None) -> SolveResult:
    """Solve A x = b with pipelined BiCGStab (Cools-Vanroose Alg. 5).

    With ``precond`` set, the M^{-1}-applies ride inside each matvec and
    both reduction phases keep their distance from the in-flight
    preconditioned matvec (the dots never read its output).  Other
    arguments as in :func:`repro_torch.core.bicgstab.bicgstab_solve`.
    """
    return solve_chunked(PBICGSTAB, matvec, b, x0, config=config,
                         r0_star=r0_star, substrate=substrate,
                         precond=precond, dot_reduce=dot_reduce,
                         stats=stats)
