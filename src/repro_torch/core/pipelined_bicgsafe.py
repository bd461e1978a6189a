"""p-BiCGSafe — communication-hiding pipelined BiCGSafe (paper Alg. 3.1)
and p-BiCGSafe-rr — with residual replacement (paper Alg. 4.1).  PyTorch
port of ``repro.core.pipelined_bicgsafe``.

The matvec results are replaced by recurrences on auxiliary vectors

    q_i = A s_i + beta_i l_{i-1}              (== A o_i,   Eqn. 3.5)
    w_i = zeta_i q_i + eta_i(g_i + beta_i w_{i-1})   (== A u_i, Eqn. 3.9)
    l_i = q_i - A w_i                         (== A t_i,   Eqn. 3.7)
    g_{i+1} = zeta_i A s_i + eta_i g_i - alpha_i A w_i  (== A y_{i+1}, 3.10)
    s_{i+1} = s_i - alpha_i q_i - g_{i+1}     (== A r_{i+1}, Eqn. 3.2)

so the single fused reduction of an iteration reads only ``s_i, y_i, r_i,
t_{i-1}`` and ``r0*``, none of which depend on the iteration's matvec
``A s_i``.

The loop.  PyTorch has no device-side while loop, so the iterations run in
chunks of ``CHUNK`` steps queued by the host.  Each step computes the next
state and the stopped state exactly as the JAX loop body does, and selects
between them on the device (``tree_select``); a state that has already
stopped (converged or broken down) is carried unchanged, as the JAX
``while_loop`` would no longer run its body.  The host reads one flag per
chunk, so ``iterations`` is exact and a chunk makes one host sync.  A chunk
never runs past ``maxiter``.  The -rr replacement step is chosen on the
host: it knows ``i`` for every step that has not stopped, and a stopped
step's result is discarded anyway.  Steps queued after the state stopped,
within its last chunk, still launch their kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ._common import (bicgsafe_coefficients, init_guess,
                      pipelined_recurrence_tail, tree_select)
from .substrate import SubstrateLike, get_substrate
from .types import (SolveResult, SolverConfig, classify_status, history_init,
                    history_update)

#: iterations queued between two host reads of the stop flag
CHUNK = 16


def _pipelined_solve(matvec, b, x0, config: SolverConfig, r0_star,
                     residual_replacement: bool, substrate: SubstrateLike,
                     precond=None,
                     stats: Optional[Dict[str, int]] = None) -> SolveResult:
    if precond is not None:
        raise NotImplementedError(
            "precond= is not ported to repro_torch yet")
    sub = get_substrate(substrate)
    stats = {} if stats is None else stats
    for key in ("steps", "rr_steps", "host_reads"):
        stats.setdefault(key, 0)
    eps = config.breakdown_threshold(b.dtype)
    x = init_guess(b, x0)
    r0 = b - matvec(x) if x0 is not None else b          # MV (init)
    rs = r0 if r0_star is None else r0_star.to(b.dtype)
    s0 = matvec(r0)                                      # MV (init): s_0 = A r_0

    norm_r0 = torch.sqrt(sub.dots([(r0, r0)])[0])
    # ||r_0|| == 0 (zero rhs, or exact initial guess): x already solves
    # the system — converge at t=0 instead of dividing by zero below.
    conv0 = norm_r0 == 0
    norm_r0 = torch.where(conv0, torch.ones_like(norm_r0), norm_r0)
    z0 = torch.zeros_like(b)
    hist = history_init(config, norm_r0.dtype, b.device)

    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    false = torch.zeros((), dtype=torch.bool, device=b.device)
    state = dict(
        x=x, r=r0, s=s0, p=z0, u=z0, t=z0, y=z0, z=z0, w=z0, l=z0, g=z0,
        alpha=zero, zeta=one, f=one,
        i=torch.zeros((), dtype=torch.int32, device=b.device),
        relres=torch.where(conv0, 0.0, 1.0).to(norm_r0.dtype),
        converged=conv0,
        breakdown=false, hist=hist)

    def step(st, i_host: int):
        """One iteration of the JAX loop body; ``i_host`` is the host's
        count, exact whenever the state has not stopped."""
        active = ~st["converged"] & ~st["breakdown"]
        r, s, y, t_prev = st["r"], st["s"], st["y"], st["t"]

        # MV #1 (A s_i) and the fused reduction are mutually independent:
        # the dots read only {s, y, r, t_prev, rs}.
        As = matvec(s)
        dots = sub.bicgsafe_dots(s, y, r, t_prev, rs)

        beta, alpha, zeta, eta, f, rr, bad = bicgsafe_coefficients(
            dots, st["i"], st["alpha"], st["zeta"], st["f"], eps)
        relres = torch.sqrt(torch.abs(rr)) / norm_r0
        done = relres <= config.tol

        # blocked vector-update phase (Alg. 3.1 lines 23-32): one substrate
        # call covers all 10 recurrence updates
        upd = sub.axpy_phase(
            dict(r=r, p=st["p"], u=st["u"], t=t_prev, y=y, z=st["z"],
                 s=s, l=st["l"], g=st["g"], w=st["w"], x=st["x"], As=As),
            (alpha, beta, zeta, eta))
        p, o, u, q, w = (upd[k] for k in ("p", "o", "u", "q", "w"))
        t, z, y_next, x_next, r_next = (
            upd[k] for k in ("t", "z", "y", "x", "r"))

        do_rr = residual_replacement and i_host % config.rr_epoch == 0 \
            and 0 < i_host < config.rr_maxiter
        if not do_rr:
            Aw = matvec(w)                                # MV #2 (A w_i)
            l, g_next, s_next = pipelined_recurrence_tail(
                q, s, As, st["g"], Aw, alpha, zeta, eta)
        else:
            # Alg. 4.1 lines 26-33 + 38-45: w from a true matvec, then
            # reset r, l, g, s to their true values (p, o, u, z keep their
            # recurrence values — they are exact either way).
            stats["rr_steps"] += 1
            w = matvec(u)                                 # true A u_i
            t = o - w
            y_next = zeta * s + eta * y - alpha * w
            x_next = st["x"] + alpha * p + z
            r_next = b - matvec(x_next)
            l = matvec(t)
            g_next = matvec(y_next)
            s_next = matvec(r_next)

        hist_i = history_update(st["hist"], st["i"], relres, config, active)
        new = dict(
            x=x_next, r=r_next, s=s_next, p=p, u=u, t=t, y=y_next, z=z,
            w=w, l=l, g=g_next,
            alpha=alpha, zeta=zeta, f=f,
            i=st["i"] + 1, relres=relres,
            converged=false, breakdown=false, hist=hist_i)
        # the stopped state of the JAX body; a state that had already
        # stopped keeps its flags and residual as well
        held = dict(st)
        held.update(relres=torch.where(active, relres, st["relres"]),
                    converged=torch.where(active, done, st["converged"]),
                    breakdown=torch.where(active, bad & ~done,
                                          st["breakdown"]),
                    hist=hist_i)
        stats["steps"] += 1
        return tree_select(~active | done | bad, held, new)

    i_host = 0
    while i_host < config.maxiter:
        stats["host_reads"] += 1
        if bool(state["converged"] | state["breakdown"]):
            break
        n_steps = min(CHUNK, config.maxiter - i_host)
        for j in range(n_steps):
            state = step(state, i_host + j)
        i_host += n_steps

    st = state
    return SolveResult(st["x"], st["i"], st["relres"], st["converged"],
                       st["breakdown"], st["hist"],
                       classify_status(st["converged"], st["breakdown"],
                                       st["relres"]), None)


def pbicgsafe_solve(matvec: Callable,
                    b: torch.Tensor,
                    x0: Optional[torch.Tensor] = None,
                    *,
                    config: SolverConfig = SolverConfig(),
                    r0_star: Optional[torch.Tensor] = None,
                    substrate: SubstrateLike = "torch",
                    precond=None,
                    stats: Optional[Dict[str, int]] = None) -> SolveResult:
    """Solve A x = b with p-BiCGSafe (paper Alg. 3.1).

    ``matvec`` is a callable or an operator (dispatched through the
    substrate).  ``stats``, when given, accumulates ``steps`` (iterations
    queued, stopped ones included), ``rr_steps`` and ``host_reads``.
    """
    sub = get_substrate(substrate)
    return _pipelined_solve(sub.as_matvec(matvec), b, x0, config, r0_star,
                            residual_replacement=False, substrate=sub,
                            precond=precond, stats=stats)


def pbicgsafe_rr_solve(matvec: Callable,
                       b: torch.Tensor,
                       x0: Optional[torch.Tensor] = None,
                       *,
                       config: SolverConfig = SolverConfig(),
                       r0_star: Optional[torch.Tensor] = None,
                       substrate: SubstrateLike = "torch",
                       precond=None,
                       stats: Optional[Dict[str, int]] = None) -> SolveResult:
    """Solve A x = b with p-BiCGSafe-rr (paper Alg. 4.1).

    ``config.rr_epoch`` is the paper's ``m``, ``config.rr_maxiter`` the
    cutoff ``M``.  Other arguments as in :func:`pbicgsafe_solve`.
    """
    sub = get_substrate(substrate)
    return _pipelined_solve(sub.as_matvec(matvec), b, x0, config, r0_star,
                            residual_replacement=True, substrate=sub,
                            precond=precond, stats=stats)
