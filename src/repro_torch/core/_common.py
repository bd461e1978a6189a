"""Shared machinery for the Krylov solvers (PyTorch port of
``repro.core._common``).

Every scalar the iteration computes stays a 0-d tensor on the solve's
device, so the coefficient algebra below never reads the device from the
host: a chunk of iterations queues its work without a sync.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import torch

from .types import (SolveResult, SolveStatus, classify_status,
                    identity_reduce, trace_init, trace_record)

#: whether the step bodies tag their phases (:func:`phase`): on only while
#: a :func:`repro_torch.observe.profile.capture` is open
_TAGS = [False]
_UNTAGGED = contextlib.nullcontext()


def phase(name: str):
    """A ``torch.profiler.record_function`` range named ``name``
    (``repro.matvec`` / ``repro.reduce`` / ``repro.axpy``, and
    ``repro.step`` around a whole step) while a profile capture is open,
    else a no-op: the counterpart of the JAX package's
    ``jax.named_scope`` tags, which cost an unprofiled solve nothing.  The
    ranges enclose the eager launches; a graph replay carries none, so
    :mod:`repro_torch.observe.profile` maps kernel names to phases from an
    eager run."""
    return torch.profiler.record_function(name) if _TAGS[0] else _UNTAGGED


def local_dots(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
               ) -> torch.Tensor:
    """Stack the inner products <a,b> of each pair into one vector (one
    reduction phase): ``(k,)`` for ``(n,)`` vectors, ``(k, m)`` per-column
    dots for ``(n, m)`` blocks (summed in ``promote(dtype, float32)``)."""
    if pairs[0][0].dim() == 1:
        return torch.stack([torch.dot(a, b) for a, b in pairs])
    acc = torch.promote_types(pairs[0][0].dtype, torch.float32)
    return torch.stack([(a * b).sum(0, dtype=acc) for a, b in pairs])


def safe_div(num: torch.Tensor, den: torch.Tensor, eps: float):
    """num/den with breakdown detection: returns (value, is_breakdown)."""
    bad = torch.abs(den) <= eps
    val = num / torch.where(bad, torch.ones_like(den), den)
    return torch.where(bad, torch.zeros_like(val), val), bad


def init_guess(b: torch.Tensor, x0: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.zeros_like(b) if x0 is None else x0.to(b.dtype)


def tree_select(pred, on_true: dict, on_false: dict) -> dict:
    """Elementwise select over two dicts of tensors (``pred`` a 0-d bool
    tensor).  An entry that is the same tensor on both sides is passed
    through without a copy."""
    return {k: a if a is on_false[k] else torch.where(pred, a, on_false[k])
            for k, a in on_true.items()}


def hold_checked(st: dict, new: dict, active, relres, done,
                 hist) -> dict:
    """The state after one step of a method that checks the recurred
    ``||r_i||`` it was given (BiCGStab, p-BiCGStab, GPBi-CG, CGS): ``new``
    while the state runs and is not ``done``; else the JAX body's stopped
    state (this check's relres, flag and history), and once stopped the
    state as it was."""
    held = dict(st)
    held.update(relres=torch.where(active, relres, st["relres"]),
                converged=torch.where(active, done, st["converged"]),
                hist=hist)
    return tree_select(active & ~done, new, held)


def hold_in_step(st: dict, new: dict, active, relres, done, bad,
                 logs: dict) -> dict:
    """The state after one step of a method that decides its stop from
    the step's own dots (p-BiCGSafe, -rr, ssBiCGSafe2): ``new`` while the
    state runs and the step found neither convergence nor a breakdown;
    else the JAX body's stopped state (the state it was given, with this
    step's relres, flags and ``logs``: the history, and the trace ring of
    :func:`trace_row`), and once stopped the state as it was (the logs
    keep their slots themselves)."""
    held = dict(st)
    held.update(relres=torch.where(active, relres, st["relres"]),
                converged=torch.where(active, done, st["converged"]),
                breakdown=torch.where(active, bad & ~done, st["breakdown"]),
                **logs)
    new.update(logs)
    return tree_select(~active | done | bad, held, new)


def trace_row(st: dict, dots: torch.Tensor, beta, relres, done, bad,
              active) -> dict:
    """Record one single-RHS iteration into the state's trace ring, when
    it has one (``SolverConfig.trace_cap``; the JAX package's
    ``_trace_row``), and return the logs :func:`hold_in_step` carries
    (``{}`` without a ring).  Every channel re-expresses a value the step
    already computed, beside it: nothing here feeds the iteration, so a
    traced step is the untraced one bit for bit.

    The iteration channel is the number of COMPLETED updates when relres
    was measured (the history's indexing): the first row is ``(0, 1.0,
    ...)`` and the terminal row ``(iterations, final relres, ...,
    CONVERGED/BREAKDOWN)``.  ``trace_steps`` counts the rows written: a
    step queued after the state stopped (``active`` false) writes none."""
    if "trace" not in st:
        return {}
    status = torch.where(done, SolveStatus.CONVERGED.value,
                         torch.where(bad, SolveStatus.BREAKDOWN.value,
                                     SolveStatus.RUNNING.value))
    trace_record(st["trace"], st["i"], trace_channels(
        dots, beta, st["i"], relres, st, torch.zeros_like(relres), status),
        active)
    return dict(trace=st["trace"],
                trace_steps=st["trace_steps"] + active.to(torch.int32))


def trace_channels(dots: torch.Tensor, beta, count, relres, st: dict,
                   drift, status) -> tuple:
    """The :data:`~repro_torch.core.types.TRACE_CHANNELS` of one step, from
    the values it computed: ``count`` the completed updates (``i``, or
    each column's ``iterations``), the rho denominator ``zeta * f`` of the
    state it was given, the alpha denominator ``g + beta h`` and the omega
    one (``a`` on the first step, else ``a b - c^2``), re-expressed as
    ``bicgsafe_coefficients`` forms them."""
    a_d, b_d, c_d, g_d, h_d = (dots[k] for k in (0, 1, 2, 6, 7))
    return (count, relres, st["zeta"] * st["f"], g_d + beta * h_d,
            torch.where(count == 0, a_d, a_d * b_d - c_d * c_d), drift,
            status)


def trace_state(config, dtype, device) -> dict:
    """The ring fields a single-RHS state starts with (``{}`` untraced)."""
    if not config.trace_cap:
        return {}
    return dict(trace=trace_init(config, dtype, device),
                trace_steps=torch.zeros((), dtype=torch.int32, device=device))


def state_result(st: dict) -> SolveResult:
    """The result of such a method: the state's own flags and relres, and
    the trace ring's payload when it has one."""
    trace = {"buffer": st["trace"], "steps": st["trace_steps"]} \
        if "trace" in st else None
    return SolveResult(st["x"], st["i"], st["relres"], st["converged"],
                       st["breakdown"], st["hist"],
                       classify_status(st["converged"], st["breakdown"],
                                       st["relres"]), trace)


def tol_const(config, like: torch.Tensor) -> torch.Tensor:
    """``config.tol`` as a 0-d tensor of ``like``'s type and device: a
    method's stop test reads it from the program's constant buffers, so
    one program serves every ``tol`` (the comparison against a Python
    float casts it to the same type)."""
    return torch.tensor(config.tol, dtype=like.dtype, device=like.device)


def recurred_result(st: dict, norm_r0: torch.Tensor, tol: torch.Tensor
                    ) -> SolveResult:
    """The result of such a method: the loop may end on maxiter after an
    unchecked update, so the final relres is derived again from the last
    recurred ``||r||^2``."""
    relres = torch.where(st["converged"], st["relres"],
                         torch.sqrt(torch.abs(st["rr"])) / norm_r0)
    converged = st["converged"] | (relres <= tol)
    return SolveResult(st["x"], st["i"], relres, converged, st["breakdown"],
                       st["hist"], classify_status(converged, st["breakdown"],
                                                   relres), None)


def _first(i, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(i, device=like.device) == 0


def bicgsafe_coefficients(dots: torch.Tensor, i, alpha_prev, zeta_prev,
                          f_prev, eps: float, typed: bool = False):
    """Coefficients shared by ssBiCGSafe2 (Alg 2.3) and p-BiCGSafe (Alg 3.1).

    ``dots = [a, b, c, d, e, f, g, h, rr]`` with
      a=(s,s) b=(y,y) c=(s,y) d=(s,r) e=(y,r)
      f=(r0*,r) g=(r0*,s) h=(r0*,t_{i-1}) rr=(r,r).

    i = 0:  beta=0, alpha=f/g, zeta=d/a, eta=0          (paper lines 10-14)
    i > 0:  beta=(alpha_{i-1} f)/(zeta_{i-1} f_{i-1}),
            alpha=f/(g + beta h),
            zeta=(b d - c e)/(a b - c^2),
            eta =(a e - c d)/(a b - c^2)                (paper lines 16-20)

    ``i`` may be a 0-d device tensor (the solver's) or an int.  For the
    multi-RHS solve ``dots`` is ``(9, m)``, ``i`` the ``(m,)`` per-column
    iteration counts and the carries ``(m,)``: everything is elementwise.
    Returns (beta, alpha, zeta, eta, f, rr, breakdown), and with ``typed``
    also the :func:`bicgsafe_breakdown_code` of the same step, derived from
    the denominators' flags computed here (the same predicates).
    """
    a, b, c, d, e, f, g, h, rr = dots.unbind(0)
    first = _first(i, f)

    beta_g, bad_beta = safe_div(alpha_prev * f, zeta_prev * f_prev, eps)
    beta = torch.where(first, torch.zeros_like(f), beta_g)

    alpha, bad_alpha = safe_div(f, g + beta * h, eps)

    zeta0, bad_z0 = safe_div(d, a, eps)
    denom = a * b - c * c
    zeta_g, bad_zg = safe_div(b * d - c * e, denom, eps)
    eta_g, _ = safe_div(a * e - c * d, denom, eps)
    zeta = torch.where(first, zeta0, zeta_g)
    eta = torch.where(first, torch.zeros_like(f), eta_g)

    breakdown = torch.where(first, bad_z0 | bad_alpha,
                            bad_beta | bad_alpha | bad_zg)
    if not typed:
        return beta, alpha, zeta, eta, f, rr, breakdown
    code = _breakdown_code(first, ~first & bad_beta, bad_alpha,
                           torch.where(first, bad_z0, bad_zg))
    return beta, alpha, zeta, eta, f, rr, breakdown, code


def _breakdown_code(first, bad_rho, bad_alpha, bad_pivot) -> torch.Tensor:
    """The first offender, rho -> alpha -> omega, as an int32 code."""
    zero = torch.zeros((), dtype=torch.int32, device=bad_alpha.device)
    code = torch.where(bad_pivot, SolveStatus.BREAKDOWN_OMEGA.value, zero)
    code = torch.where(first & bad_pivot, SolveStatus.BREAKDOWN_ALPHA.value,
                       code)
    code = torch.where(bad_alpha, SolveStatus.BREAKDOWN_ALPHA.value, code)
    code = torch.where(bad_rho, SolveStatus.BREAKDOWN_RHO.value, code)
    return code.to(torch.int32)


def bicgsafe_breakdown_code(dots: torch.Tensor, i, alpha_prev, zeta_prev,
                            f_prev, eps: float) -> torch.Tensor:
    """Typed cause of a BiCGSafe coefficient breakdown, as an int32
    :class:`SolveStatus` code (0 == no breakdown), naming the first
    offender in the order rho -> alpha -> omega:

    * BREAKDOWN_RHO:   beta denominator ``zeta_{i-1} * f_{i-1}`` (i > 0)
    * BREAKDOWN_ALPHA: alpha denominator ``g + beta * h`` (incl. the
      i == 0 pivot ``(s,s)`` of ``zeta_0 = d/a``)
    * BREAKDOWN_OMEGA: zeta/eta denominator ``a*b - c^2`` (i > 0)
    """
    a, b, c, _d, _e, f, g, h, _rr = dots.unbind(0)
    first = _first(i, f)

    bad_rho = (~first) & (torch.abs(zeta_prev * f_prev) <= eps)
    beta_g, _ = safe_div(alpha_prev * f, zeta_prev * f_prev, eps)
    beta = torch.where(first, torch.zeros_like(f), beta_g)
    bad_alpha = torch.abs(g + beta * h) <= eps
    bad_pivot = torch.where(first, torch.abs(a) <= eps,
                            torch.abs(a * b - c * c) <= eps)
    return _breakdown_code(first, bad_rho, bad_alpha, bad_pivot)


def pipelined_recurrence_tail(q, s, As, g, Aw, alpha, zeta, eta):
    """p-BiCGSafe's recurred A-images after MV #2 (Aw = A w_i).

    Returns (l, g_next, s_next) per Eqns. 3.7 / 3.10 / 3.2:
    l_i == A t_i, g_{i+1} == A y_{i+1}, s_{i+1} == A r_{i+1}.
    """
    l = q - Aw
    g_next = zeta * As + eta * g - alpha * Aw
    s_next = s - alpha * q - g_next
    return l, g_next, s_next


def _identity(handle):
    return handle


class Reducer:
    """One reduction phase as two calls: ``start(partials) -> handle``
    issues it, ``wait(handle) -> reduced`` returns the global values.  A
    solver body starts the reduction, queues the work that reads none of
    it (the iteration's matvec, where the body allows), then waits: the
    window in which an asynchronous collective hides
    (:mod:`repro_torch.core.distributed`).  Calling a reducer does both at
    once, the JAX package's ``dot_reduce(partials)``."""

    def __init__(self, start: Callable, wait: Optional[Callable] = None):
        self.start = start
        self.wait = _identity if wait is None else wait

    def __call__(self, partials: torch.Tensor) -> torch.Tensor:
        return self.wait(self.start(partials))


#: the single-process reduction: the local partials are the global values
IDENTITY = Reducer(identity_reduce)


def as_reducer(dot_reduce) -> Reducer:
    """``None`` -> :data:`IDENTITY`; a :class:`Reducer` as it is; any
    other callable ``f`` (a user's ``dot_reduce``) -> start = ``f``, wait =
    the identity, so it computes what the JAX package's hook computes."""
    if dot_reduce is None:
        return IDENTITY
    if isinstance(dot_reduce, Reducer):
        return dot_reduce
    return Reducer(dot_reduce)


class SyncCounter(Reducer):
    """Counter of the reductions started (sync phases per iteration)
    around any ``dot_reduce`` (a callable or a :class:`Reducer`);
    ``shapes`` holds the shapes of the partials it started.  Under a CUDA
    graph the steps run without Python: a
    :class:`~repro_torch.core.program.Program` given the counter adds the
    starts its capture recorded on every replay, so ``calls`` reads as it
    would for the eager chunk."""

    def __init__(self, reduce_fn=None):
        self._inner = as_reducer(reduce_fn)
        self.calls = 0
        self.shapes = set()
        super().__init__(self._start, self._inner.wait)

    def _start(self, partials: torch.Tensor):
        self._count(partials)
        return self._inner.start(partials)

    def _count(self, partials: torch.Tensor) -> None:
        self.calls += 1
        self.shapes.add(tuple(partials.shape))

    def around(self, reduce_fn) -> Reducer:
        """``reduce_fn`` as a :class:`Reducer` whose starts this counter
        counts (one counter for the reductions of several solves)."""
        inner = as_reducer(reduce_fn)

        def start(partials: torch.Tensor):
            self._count(partials)
            return inner.start(partials)
        return Reducer(start, inner.wait)
