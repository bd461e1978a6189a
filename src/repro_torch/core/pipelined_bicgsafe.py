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
chunks of ``CHUNK`` steps queued by the host (:func:`run_chunked`), each
chunk one :class:`~repro_torch.core.program.Program` run: a CUDA graph
replay on the card, the eager steps on the CPU.  Each step computes the
next state and the stopped state exactly as the JAX loop body does, and
selects between them on the device (``tree_select``); a state that has
already stopped (converged or broken down) is carried unchanged, as the
JAX ``while_loop`` would no longer run its body.  The host reads one flag
per chunk, so ``iterations`` is exact and a chunk makes one host sync.  A
chunk never runs past ``maxiter``.  The -rr replacement step is chosen on
the host: it knows ``i`` for every step that has not stopped, and a
stopped step's result is discarded anyway; each distinct pattern of
replacement steps in a chunk is a program of its own.  Steps queued after
the state stopped, within its last chunk, still launch their kernels.

Every single-RHS method of the port is a :class:`ChunkedMethod` (its
eager set-up, its loop body, its result) run by :func:`solve_chunked`.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..precond.base import PrecondLike, preconditioned_system
from ._common import (as_reducer, bicgsafe_coefficients, hold_in_step,
                      init_guess, phase, pipelined_recurrence_tail,
                      state_result, tol_const, trace_row, trace_state)
from .program import Program
from .substrate import SubstrateLike, get_substrate
from .types import (DotReduce, SolveResult, SolverConfig, history_init,
                    history_update)

#: iterations queued between two host reads of the stop flag
CHUNK = 16


class ChunkedMethod(NamedTuple):
    """A single-RHS method as :func:`solve_chunked` runs it.

    * ``init(matvec, b, x0, r0_star, config, sub, reduce) -> (state,
      consts)``: the eager set-up; ``consts`` are the per-solve tensors the
      body reads and never changes;
    * ``step(state, consts, replace, *, matvec, sub, config, reduce) ->
      state``: one iteration of the JAX loop body, reading the device
      only; ``replace`` is the host's choice of an -rr replacement step;

    Every inner product of both goes through ``reduce`` (a
    :class:`~repro_torch.core._common.Reducer`): started, then waited on
    after whatever matvec the JAX body lets it run beside.
    * ``result(state, consts, config) -> SolveResult``;
    * ``replace(i_host, config) -> bool``: the steps that replace the
      residual (``None``: the method has none)."""

    init: Callable
    step: Callable
    result: Callable
    replace: Optional[Callable] = None


def run_chunked(program: Program, state: dict, consts: dict, maxiter: int,
                stats: Optional[Dict[str, int]],
                replace: Optional[Callable[[int], bool]] = None) -> dict:
    """The host loop of every single-RHS solver of the port.

    Loads ``state`` into ``program`` and runs it in chunks of
    :data:`CHUNK` steps, reading the stop flag (``converged | breakdown``)
    once before each chunk; a chunk never runs past ``maxiter``.  A chunk
    is the tuple of ``replace(i_host)`` over its steps, ``i_host`` the
    host's count of steps, exact whenever the state has not stopped; a
    step must carry a stopped state unchanged.  ``stats`` accumulates
    ``steps`` (queued, stopped ones included) and ``host_reads``, and with
    ``replace`` ``rr_steps``, when given.  Returns the final state.
    """
    stats = {} if stats is None else stats
    for key in ("steps", "host_reads") + (("rr_steps",) if replace else ()):
        stats.setdefault(key, 0)
    program.load(state, consts)
    i_host = 0
    while i_host < maxiter:
        stats["host_reads"] += 1
        st = program.state
        if bool(st["converged"] | st["breakdown"]):
            break
        n_steps = min(CHUNK, maxiter - i_host)
        schedule = tuple(bool(replace and replace(i))
                         for i in range(i_host, i_host + n_steps))
        program.run(schedule)
        stats["steps"] += n_steps
        if replace:
            stats["rr_steps"] += sum(schedule)
        i_host += n_steps
    return program.read()


def solve_chunked(method: ChunkedMethod, matvec, b: torch.Tensor,
                  x0: Optional[torch.Tensor] = None, *,
                  config: SolverConfig, r0_star: Optional[torch.Tensor],
                  substrate: SubstrateLike, precond: PrecondLike = None,
                  dot_reduce: Optional[DotReduce] = None,
                  stats: Optional[Dict[str, int]] = None,
                  program: Optional[Callable[[Callable], Program]] = None
                  ) -> SolveResult:
    """Solve A x = b with ``method``: the left-preconditioned system's
    set-up, then :func:`run_chunked`.  ``dot_reduce`` (a callable or a
    :class:`~repro_torch.core._common.Reducer`; ``None``: the local dots
    are global) reduces every phase of inner products.  ``program(step)``
    returns the program to run the body on (a session's memoized one); by
    default a program of this call alone."""
    sub = get_substrate(substrate)
    reduce = as_reducer(dot_reduce)
    matvec, b = preconditioned_system(sub, matvec, b, precond)
    state, consts = method.init(matvec, b, x0, r0_star, config, sub, reduce)
    step = functools.partial(method.step, matvec=matvec, sub=sub,
                             config=config, reduce=reduce)
    prog = Program(step, b.device, stats=stats) if program is None \
        else program(step)
    replace = None if method.replace is None \
        else functools.partial(method.replace, config=config)
    st = run_chunked(prog, state, consts, config.maxiter, stats, replace)
    return method.result(st, consts, config)


# Left preconditioning composes M^{-1} INTO the matvec, so every recurred
# A-image below is an (M^{-1}A)-image and the algebra is unchanged; the
# apply joins the in-flight compute (the dots still read none of it), and
# -rr's replacement recomputes the preconditioned residual b' - M^{-1}A x
# through the same composite.

def _init(matvec, b, x0, r0_star, config: SolverConfig, sub, reduce):
    x = init_guess(b, x0)
    r0 = b - matvec(x) if x0 is not None else b          # MV (init)
    rs = r0 if r0_star is None else r0_star.to(b.dtype)
    s0 = matvec(r0)                                      # MV (init): s_0 = A r_0

    norm_r0 = torch.sqrt(reduce(sub.dots([(r0, r0)]))[0])
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
        breakdown=false, hist=hist,
        **trace_state(config, norm_r0.dtype, b.device))
    return state, dict(b=b, rs=rs, norm_r0=norm_r0, false=false,
                       tol=tol_const(config, norm_r0))


def _step(st, c, replace: bool, *, matvec, sub, config: SolverConfig,
          reduce):
    """One iteration of the JAX loop body; ``replace`` is the host's
    choice of a replacement step (Alg. 4.1), exact whenever the state has
    not stopped."""
    eps = config.breakdown_threshold(st["x"].dtype)
    active = ~st["converged"] & ~st["breakdown"]
    r, s, y, t_prev = st["r"], st["s"], st["y"], st["t"]

    # MV #1 (A s_i) and the fused reduction are mutually independent:
    # the dots read only {s, y, r, t_prev, rs}.  So the reduction is
    # started first, runs while A s_i is computed, and is waited on after.
    # The phase tags are no-ops unless a profile capture is open.
    with phase("repro.reduce"):
        pending = reduce.start(sub.bicgsafe_dots(s, y, r, t_prev, c["rs"]))
    with phase("repro.matvec"):
        As = matvec(s)
    with phase("repro.reduce"):
        dots = reduce.wait(pending)

    beta, alpha, zeta, eta, f, rr, bad = bicgsafe_coefficients(
        dots, st["i"], st["alpha"], st["zeta"], st["f"], eps)
    relres = torch.sqrt(torch.abs(rr)) / c["norm_r0"]
    done = relres <= c["tol"]

    # blocked vector-update phase (Alg. 3.1 lines 23-32): one substrate
    # call covers all 10 recurrence updates
    with phase("repro.axpy"):
        upd = sub.axpy_phase(
            dict(r=r, p=st["p"], u=st["u"], t=t_prev, y=y, z=st["z"],
                 s=s, l=st["l"], g=st["g"], w=st["w"], x=st["x"], As=As),
            (alpha, beta, zeta, eta))
    p, o, u, q, w = (upd[k] for k in ("p", "o", "u", "q", "w"))
    t, z, y_next, x_next, r_next = (
        upd[k] for k in ("t", "z", "y", "x", "r"))

    if not replace:
        with phase("repro.matvec"):
            Aw = matvec(w)                                # MV #2 (A w_i)
        with phase("repro.axpy"):
            l, g_next, s_next = pipelined_recurrence_tail(
                q, s, As, st["g"], Aw, alpha, zeta, eta)
    else:
        # Alg. 4.1 lines 26-33 + 38-45: w from a true matvec, then
        # reset r, l, g, s to their true values (p, o, u, z keep their
        # recurrence values — they are exact either way).
        with phase("repro.matvec"):
            w = matvec(u)                                 # true A u_i
        t = o - w
        y_next = zeta * s + eta * y - alpha * w
        x_next = st["x"] + alpha * p + z
        with phase("repro.matvec"):
            r_next = c["b"] - matvec(x_next)
            l = matvec(t)
            g_next = matvec(y_next)
            s_next = matvec(r_next)

    logs = dict(hist=history_update(st["hist"], st["i"], relres, config,
                                    active),
                **trace_row(st, dots, beta, relres, done, bad, active))
    false = c["false"]
    new = dict(
        x=x_next, r=r_next, s=s_next, p=p, u=u, t=t, y=y_next, z=z,
        w=w, l=l, g=g_next,
        alpha=alpha, zeta=zeta, f=f,
        i=st["i"] + 1, relres=relres,
        converged=false, breakdown=false)
    return hold_in_step(st, new, active, relres, done, bad, logs)


def _result(st, c, config: SolverConfig) -> SolveResult:
    return state_result(st)


def _no_replacement(i_host: int, *, config: SolverConfig) -> bool:
    return False


def _replacement(i_host: int, *, config: SolverConfig) -> bool:
    """-rr's replacement steps: every ``rr_epoch``-th, below
    ``rr_maxiter``."""
    return i_host % config.rr_epoch == 0 and 0 < i_host < config.rr_maxiter


#: p-BiCGSafe (Alg. 3.1) and p-BiCGSafe-rr (Alg. 4.1)
PBICGSAFE = ChunkedMethod(_init, _step, _result, _no_replacement)
PBICGSAFE_RR = ChunkedMethod(_init, _step, _result, _replacement)


def pbicgsafe_solve(matvec: Callable,
                    b: torch.Tensor,
                    x0: Optional[torch.Tensor] = None,
                    *,
                    config: SolverConfig = SolverConfig(),
                    r0_star: Optional[torch.Tensor] = None,
                    substrate: SubstrateLike = "torch",
                    precond: PrecondLike = None,
                    dot_reduce: Optional[DotReduce] = None,
                    stats: Optional[Dict[str, int]] = None) -> SolveResult:
    """Solve A x = b with p-BiCGSafe (paper Alg. 3.1).

    ``matvec`` is a callable or an operator (dispatched through the
    substrate).  ``precond`` (a name or a :class:`repro_torch.precond
    .Preconditioner`) runs the left-preconditioned system M^{-1} A x =
    M^{-1} b, the apply inside the overlap window of the one reduction per
    iteration; ``relres``/``tol`` are then in the preconditioned norm.
    ``dot_reduce`` (the JAX package's hook, ``partials -> reduced``, or a
    :class:`~repro_torch.core._common.Reducer`) reduces the one fused
    phase per iteration and the set-up's norm; the distributed driver's
    all-reduce is started before ``A s_i`` and waited on after it.
    ``stats``, when given, accumulates ``steps`` (iterations queued,
    stopped ones included), ``rr_steps`` and ``host_reads``.
    """
    return solve_chunked(PBICGSAFE, matvec, b, x0, config=config,
                         r0_star=r0_star, substrate=substrate,
                         precond=precond, dot_reduce=dot_reduce,
                         stats=stats)


def pbicgsafe_rr_solve(matvec: Callable,
                       b: torch.Tensor,
                       x0: Optional[torch.Tensor] = None,
                       *,
                       config: SolverConfig = SolverConfig(),
                       r0_star: Optional[torch.Tensor] = None,
                       substrate: SubstrateLike = "torch",
                       precond: PrecondLike = None,
                       dot_reduce: Optional[DotReduce] = None,
                       stats: Optional[Dict[str, int]] = None) -> SolveResult:
    """Solve A x = b with p-BiCGSafe-rr (paper Alg. 4.1).

    ``config.rr_epoch`` is the paper's ``m``, ``config.rr_maxiter`` the
    cutoff ``M``.  Other arguments as in :func:`pbicgsafe_solve`; with
    ``precond`` the replacement step recomputes the residual of the
    preconditioned system, so recurred and replaced quantities agree.
    """
    return solve_chunked(PBICGSAFE_RR, matvec, b, x0, config=config,
                         r0_star=r0_star, substrate=substrate,
                         precond=precond, dot_reduce=dot_reduce,
                         stats=stats)
