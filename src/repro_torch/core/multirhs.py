"""Batched multi-RHS solves: A X = B for (n, m) right-hand sides (PyTorch
port of ``repro.core.multirhs``).

One batched p-BiCGSafe iteration streams ``(n, m)`` blocks through every
vector phase and does ONE fused reduction, a ``(9, m)`` block of per-column
dots, whatever m is; the dot phase still reads only ``{s, y, r, t_prev,
rs}``, none of which depends on the in-flight block matvec ``A S``.  Each
column keeps its own coefficients ("individual" blocked mode), so a column
converges as its own single-RHS solve would, and a column that converged,
broke down or used up its budget is frozen while the rest go on.  On the
``"cuda"`` substrate the fused ``(9, m)`` dots, the ``(n, m)`` update phase
(which freezes columns inside the kernel) and the block ELL SpMV are the
hand-written kernels of :mod:`repro_torch.kernels`.

Open-loop pieces, as in the JAX package (what its service drives):

* :func:`init_state`     — the per-column Krylov state, a dict of tensors;
* :func:`step_chunk`     — advance every live column by up to k iterations;
* :func:`splice_columns` — refill a masked subset of columns with fresh
                           right-hand sides mid-flight; the other columns
                           are left bit for bit as they were;
* :func:`result_from_state` — package a state as a :class:`SolveResult`.

:func:`solve_batched` is init plus one chunk of ``config.maxiter`` steps.

The loop.  PyTorch has no device-side while loop: :func:`step_chunk`
queues steps in groups of ``pipelined_bicgsafe.CHUNK`` (16), each one run
of a :class:`~repro_torch.core.program.Program` (a CUDA graph replay on the
card, the eager steps on the CPU), and reads ``any(active)`` on the host
once per group, never queuing more than k steps in all.  A step queued after every column stopped must leave the
state bitwise as it was, as the JAX loop would no longer run its body: every
field is a per-column select, and the global counter ``i`` (history slot)
advances by ``any(active)``, not by 1.  The JAX package's ``dot_reduce``
(the sharded solve's psum) is not part of the port yet.

The guard.  With ``SolverConfig.guard`` the fused phase is the ``(11, m)``
health variant (still one reduction, still no edge to ``A S``: its extra
operand is the previous iterate ``x``), and the state carries the
per-column fields of :data:`GUARD_FIELDS`: a typed :class:`SolveStatus`, a
NaN/Inf detector that freezes a poisoned column, the Cools drift bound and
a stagnation counter, which :class:`repro_torch.resilience.GuardedSolver`
reads at chunk boundaries.  Each of them changes only under ``active`` or
``advance``, so a queued step leaves them bitwise as they were too.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..precond.base import PrecondLike, wrap_block_preconditioned
from . import pipelined_bicgsafe
from ._common import bicgsafe_coefficients, pipelined_recurrence_tail
from .linear_operator import batched_matvec
from .program import Program
from .substrate import SubstrateLike, get_substrate
from .types import (SolveResult, SolverConfig, SolveStatus, classify_status,
                    per_column)

__all__ = ["GUARD_FIELDS", "active_columns", "batched_matvec", "init_state",
           "splice_columns", "step_chunk", "result_from_state",
           "solve_batched"]

#: Per-column health fields of a guarded state (``SolverConfig.guard``);
#: their presence marks a state as guarded.
GUARD_FIELDS = ("status", "drift", "drift_flag", "stall", "best_relres",
                "stagnant", "replacements", "restarts")


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet")


def _guard_init(m: int, rdtype, conv0: torch.Tensor) -> dict:
    """Fresh guard fields for ``m`` columns (``conv0``: the columns
    converged at t=0, i.e. zero right-hand sides)."""
    dev = conv0.device
    return dict(
        status=torch.where(conv0, SolveStatus.CONVERGED.value,
                           SolveStatus.RUNNING.value).to(torch.int32),
        drift=torch.zeros(m, dtype=rdtype, device=dev),
        drift_flag=torch.zeros(m, dtype=torch.bool, device=dev),
        stall=torch.zeros(m, dtype=torch.int32, device=dev),
        best_relres=torch.full((m,), float("inf"), dtype=rdtype, device=dev),
        stagnant=torch.zeros(m, dtype=torch.bool, device=dev),
        replacements=torch.zeros(m, dtype=torch.int32, device=dev),
        restarts=torch.zeros(m, dtype=torch.int32, device=dev))


def _masked(mask_cols: torch.Tensor, new: torch.Tensor, old: torch.Tensor
            ) -> torch.Tensor:
    """Per-column select: ``mask_cols`` is (m,); the operands are (m,) or
    (n, m).  (The JAX package's broadcast of a squeezed m = 1 operand
    serves a user ``dot_reduce``, which the port does not take.)"""
    return torch.where(mask_cols, new, old)


def active_columns(state: dict) -> torch.Tensor:
    """(m,) bool: columns still iterating (not converged, not broken down,
    and below their own iteration budget)."""
    return (~state["converged"] & ~state["breakdown"]
            & (state["iterations"] < state["col_maxiter"]))


def _shadow(r0_star, like: torch.Tensor) -> torch.Tensor:
    """The shadow residual block: an (n,) vector shared by every column, or
    an (n, m) block of per-column shadows."""
    rs = r0_star.to(like.dtype)
    if rs.dim() == 1:
        rs = rs[:, None].expand(like.shape)
    return rs.contiguous()


def init_state(bmv: Callable,
               B: torch.Tensor,
               X0: Optional[torch.Tensor] = None,
               *,
               config: SolverConfig = SolverConfig(),
               r0_star: Optional[torch.Tensor] = None,
               substrate: SubstrateLike = "torch",
               tol=None,
               maxiter=None) -> dict:
    """Build the batched p-BiCGSafe state for ``A X = B``.

    ``bmv`` is the ``(n, m) -> (n, m)`` block matvec; ``B`` the (n, m)
    right-hand sides (under preconditioning, ``bmv`` is ``M^{-1} ∘ A`` and
    ``B`` is ``M^{-1} B``: :func:`solve_batched` and the session compose
    them); ``X0`` optional (n, m) initial guesses.  ``tol`` and
    ``maxiter`` are per column, a scalar or ``(m,)``; they default to
    ``config.tol`` / ``config.maxiter``.  Costs one block matvec
    (``S_0 = A R_0``; two with an ``X0``) and one ``(1, m)`` dot phase.
    With ``config.guard`` the state also holds :data:`GUARD_FIELDS`.
    """
    sub = get_substrate(substrate)
    B = B.contiguous()
    n, m = B.shape
    X = torch.zeros_like(B) if X0 is None else X0.to(B.dtype).contiguous()
    R0 = B - bmv(X) if X0 is not None else B
    RS = R0 if r0_star is None else _shadow(r0_star, B)
    S0 = bmv(R0)                                  # block MV (init): A R_0

    norm_r0 = torch.sqrt(sub.dots([(R0, R0)])[0])             # (m,)
    # ||r_0|| == 0 (zero column, or exact X0): that column already solves
    # its system; it is converged at t=0 and never advances
    conv0 = norm_r0 == 0
    Z0 = torch.zeros_like(B)
    dev = B.device
    if config.record_history:
        hist = torch.full((config.maxiter + 1, m), float("nan"),
                          dtype=norm_r0.dtype, device=dev)
    else:
        hist = torch.zeros((0, m), dtype=norm_r0.dtype, device=dev)
    st = dict(
        x=X, r=R0, s=S0, p=Z0, u=Z0, t=Z0, y=Z0, z=Z0, w=Z0, l=Z0, g=Z0,
        rs=RS,
        alpha=torch.zeros(m, dtype=B.dtype, device=dev),
        zeta=torch.ones(m, dtype=B.dtype, device=dev),
        f=torch.ones(m, dtype=B.dtype, device=dev),
        i=torch.zeros((), dtype=torch.int32, device=dev),
        iterations=torch.zeros(m, dtype=torch.int32, device=dev),
        relres=torch.where(conv0, 0.0, 1.0).to(norm_r0.dtype),
        converged=conv0,
        breakdown=torch.zeros(m, dtype=torch.bool, device=dev),
        norm_r0=norm_r0,
        tol=per_column(config.tol if tol is None else tol, m,
                       norm_r0.dtype, name="tol", device=dev),
        col_maxiter=per_column(config.maxiter if maxiter is None
                               else maxiter, m, torch.int32,
                               name="maxiter", device=dev),
        hist=hist)
    if config.guard:
        st.update(_guard_init(m, norm_r0.dtype, conv0))
    return st


def splice_columns(bmv: Callable,
                   state: dict,
                   refill,
                   B_new: torch.Tensor,
                   *,
                   r0_star: Optional[torch.Tensor] = None,
                   substrate: SubstrateLike = "torch",
                   tol=None,
                   maxiter=None) -> dict:
    """Refill the columns where ``refill`` ((m,) bool) is True with the
    same columns of ``B_new`` (n, m), from x0 = 0; every other column is
    carried through bit for bit (columns are independent).  ``tol`` and
    ``maxiter`` (scalar or (m,)) and ``r0_star`` ((n,) or (n, m)) apply to
    the fresh columns.  Costs one block matvec on the whole block (the kept
    columns ride along as zeros) and one ``(1, m)`` dot phase; the global
    counter ``i`` is kept."""
    m = state["r"].shape[1]
    sub = get_substrate(substrate)
    dt, dev = state["r"].dtype, state["r"].device
    refill = torch.as_tensor(refill, device=dev).to(torch.bool)
    B_live = torch.where(refill, B_new.to(dt), 0.0).contiguous()
    S0 = bmv(B_live)              # zero columns stay zero: bmv is linear
    norm_new = torch.sqrt(sub.dots([(B_live, B_live)])[0])
    RS_new = B_live if r0_star is None else _shadow(r0_star, B_live)
    tol_col = per_column(state["tol"] if tol is None else tol, m,
                         state["tol"].dtype, name="tol", device=dev)
    maxiter_col = per_column(state["col_maxiter"] if maxiter is None
                             else maxiter, m, torch.int32, name="maxiter",
                             device=dev)

    def sca(new, old):
        return torch.where(refill, new, old)

    zero = torch.zeros_like(B_live)
    conv_new = norm_new == 0      # a zero column is converged at t=0
    out = dict(state)
    out.update(x=sca(zero, state["x"]), r=sca(B_live, state["r"]),
               s=sca(S0, state["s"]), rs=sca(RS_new, state["rs"]))
    for k in ("p", "u", "t", "y", "z", "w", "l", "g"):
        out[k] = sca(zero, state[k])
    out.update(
        alpha=sca(torch.zeros(m, dtype=dt, device=dev), state["alpha"]),
        zeta=sca(torch.ones(m, dtype=dt, device=dev), state["zeta"]),
        f=sca(torch.ones(m, dtype=dt, device=dev), state["f"]),
        iterations=sca(torch.zeros(m, dtype=torch.int32, device=dev),
                       state["iterations"]),
        relres=sca(torch.where(conv_new, 0.0, 1.0).to(state["relres"].dtype),
                   state["relres"]),
        converged=sca(conv_new, state["converged"]),
        breakdown=sca(torch.zeros(m, dtype=torch.bool, device=dev),
                      state["breakdown"]),
        norm_r0=sca(norm_new, state["norm_r0"]),
        tol=sca(tol_col, state["tol"]),
        col_maxiter=sca(maxiter_col, state["col_maxiter"]))
    if state["hist"].shape[0]:
        out["hist"] = torch.where(refill, float("nan"), state["hist"])
    if "status" in state:
        fresh = _guard_init(m, state["norm_r0"].dtype, conv_new)
        for k in GUARD_FIELDS:
            out[k] = sca(fresh[k], state[k])
    return out


def _make_body(sub, bmv: Callable, config: SolverConfig) -> Callable:
    """One batched p-BiCGSafe iteration: state dict -> state dict.  It
    reads nothing back to the host.  ``hist`` is written in place: the
    caller hands the body a history it owns.  With ``config.guard`` the
    fused phase is the (11, m) health variant and the guard fields are
    updated (as the JAX package's body does)."""
    guard = config.guard

    def body(st):
        r, s, y, t_prev = st["r"], st["s"], st["y"], st["t"]
        eps = config.breakdown_threshold(r.dtype)
        active = active_columns(st)                               # (m,)

        # block MV and the single fused (9, m) reduction: independent, as
        # in the single-RHS iteration; the guarded (11, m) phase also reads
        # the previous iterate x (loop-carried, no edge to As)
        As = bmv(s)
        if guard:
            dots = sub.bicgsafe_dots_health(s, y, r, t_prev, st["rs"],
                                            st["x"])
        else:
            dots = sub.bicgsafe_dots(s, y, r, t_prev, st["rs"])

        # each column's i = 0 branch keys off its own iteration count, so
        # a column spliced into a running block starts correctly.  Guarded,
        # the typed breakdown code comes from the same denominators' flags
        # (bicgsafe_breakdown_code's predicates, without computing them twice)
        beta, alpha, zeta, eta, f, rr, bad, *code = bicgsafe_coefficients(
            dots[:9], st["iterations"], st["alpha"], st["zeta"], st["f"],
            eps, typed=guard)
        normr = torch.sqrt(torch.abs(rr))
        relres = normr / st["norm_r0"]
        done = relres <= st["tol"]
        if guard:
            # rows 8-10 (rr, x.x, the probe): a non-finite one freezes the
            # column as a coefficient breakdown does, so NaN never advances
            nonfinite = ~torch.isfinite(dots[8:]).all(0)
            bad = bad | nonfinite
        advance = active & ~done & ~bad                           # (m,)

        # the update phase freezes the columns that do not advance (in the
        # kernel on "cuda"): no (n, m) select afterwards for its outputs
        upd = sub.axpy_phase(
            dict(r=r, p=st["p"], u=st["u"], t=t_prev, y=y, z=st["z"],
                 s=s, l=st["l"], g=st["g"], w=st["w"], x=st["x"], As=As),
            (alpha, beta, zeta, eta), mask=advance)

        Aw = bmv(upd["w"])                                  # block MV #2
        l, g_next, s_next = pipelined_recurrence_tail(
            upd["q"], s, As, st["g"], Aw, alpha, zeta, eta)

        # the recurrence tail (l, g, s) and the per-column carries have no
        # in-kernel mask: freeze them here
        relres_out = _masked(active, relres, st["relres"])
        hist = st["hist"]
        if config.record_history:
            # slot i, as JAX's .at[i].set: past the end the write is dropped
            rows = hist.shape[0]
            idx = st["i"].clamp(max=rows - 1).to(torch.int64).reshape(1)
            keep = hist.index_select(0, idx)
            write = active & (st["i"] < rows)
            hist.index_copy_(0, idx, torch.where(
                write, relres_out.to(hist.dtype), keep))
        iters_next = torch.where(advance, st["iterations"] + 1,
                                 st["iterations"])
        out = dict(
            x=upd["x"], r=upd["r"], s=_masked(advance, s_next, s),
            p=upd["p"], u=upd["u"], t=upd["t"], y=upd["y"], z=upd["z"],
            w=upd["w"],
            l=_masked(advance, l, st["l"]),
            g=_masked(advance, g_next, st["g"]),
            rs=st["rs"],
            alpha=_masked(advance, alpha, st["alpha"]),
            zeta=_masked(advance, zeta, st["zeta"]),
            f=_masked(advance, f, st["f"]),
            # a step with no active column is the JAX loop not running
            i=st["i"] + active.any().to(st["i"].dtype),
            iterations=iters_next,
            relres=relres_out,
            converged=st["converged"] | (active & done),
            breakdown=st["breakdown"] | (active & bad & ~done),
            norm_r0=st["norm_r0"], tol=st["tol"],
            col_maxiter=st["col_maxiter"],
            hist=hist)
        if guard:
            out.update(_guard_update(config, st, dots, normr, relres, active,
                                     done, bad, nonfinite, code[0], advance,
                                     iters_next))
        return out

    return body


def _guard_update(config: SolverConfig, st: dict, dots, normr, relres,
                  active, done, bad, nonfinite, code, advance,
                  iters_next) -> dict:
    """The guard fields after one step; each changes only under ``active``
    or ``advance``.  ``normr`` is ``sqrt(|rr|)``."""
    # typed status: the first terminal event wins; a column that uses up
    # its budget is stamped MAXITER as it crosses it
    sts = st["status"]
    stopped = active & ~done
    sts = torch.where(active & done, SolveStatus.CONVERGED.value, sts)
    sts = torch.where(stopped & nonfinite, SolveStatus.NONFINITE.value, sts)
    sts = torch.where(stopped & ~nonfinite & bad,
                      torch.clamp(code, min=SolveStatus.BREAKDOWN.value), sts)
    sts = torch.where(advance & (iters_next >= st["col_maxiter"])
                      & (sts == SolveStatus.RUNNING.value),
                      SolveStatus.MAXITER.value, sts).to(torch.int32)

    # Cools / van der Vorst-Ye drift bound: the recurred-vs-true residual
    # gap grows like eps * sum_i (||A|| ||x_i|| + ||r_i||); ||A|| is
    # estimated in flight as sqrt((s, s) / (r, r)), rows 0 and 8 (a NaN
    # there only reaches a column that does not advance)
    fi = torch.finfo(normr.dtype)
    normA = torch.sqrt(torch.abs(dots[0])
                       / torch.clamp(torch.abs(dots[8]), min=fi.tiny))
    inc = fi.eps * (normA * torch.sqrt(torch.abs(dots[9])) + normr)
    drift = torch.where(advance, st["drift"] + inc, st["drift"])
    drift_flag = st["drift_flag"] | (
        advance & (drift > config.drift_threshold(normr.dtype) * st["tol"]
                   * st["norm_r0"]))

    # stagnation: consecutive steps without a new best relres; the flag
    # sticks once the window is reached
    improved = relres < st["best_relres"]
    best = torch.where(advance & improved, relres, st["best_relres"])
    stall = torch.where(advance, torch.where(improved, 0, st["stall"] + 1),
                        st["stall"]).to(torch.int32)
    stagnant = st["stagnant"]
    if config.stagnation_window > 0:
        stagnant = stagnant | (stall >= config.stagnation_window)
    return dict(status=sts, drift=drift, drift_flag=drift_flag, stall=stall,
                best_relres=best, stagnant=stagnant,
                replacements=st["replacements"], restarts=st["restarts"])


def step_chunk(bmv: Callable,
               state: dict,
               k: int,
               *,
               config: SolverConfig = SolverConfig(),
               substrate: SubstrateLike = "torch",
               stats: Optional[Dict[str, int]] = None) -> dict:
    """Advance every live column by up to ``k`` iterations; stops early
    once every column is frozen (converged, broken down, or past its own
    budget).  One (9, m) dot phase per step ((11, m) when guarded).  The
    global counter ``state["i"]`` keeps counting across chunks; per-column
    ``iterations`` count from each column's own start.  ``state`` is not
    changed.

    ``stats``, when given, accumulates ``steps`` (steps queued, frozen
    ones included) and ``host_reads`` (reads of ``any(active)``)."""
    return run_chunks(batched_program(bmv, config, substrate, stats,
                                      device=state["r"].device),
                      state, k, stats)


def batched_program(bmv: Callable, config: SolverConfig,
                    substrate: SubstrateLike = "torch",
                    stats: Optional[Dict[str, int]] = None, *, device,
                    key=None) -> Program:
    """A :class:`~repro_torch.core.program.Program` of the batched body
    (what :func:`run_chunks` runs)."""
    body = _make_body(get_substrate(substrate), bmv, config)
    return Program(lambda st, _consts, _replace: body(st), device, key,
                   stats=stats)


def run_chunks(program: Program, state: dict, k: int,
               stats: Optional[Dict[str, int]] = None) -> dict:
    """:func:`step_chunk` on ``program``: loads ``state`` (which is left as
    it was) and runs chunks of up to ``CHUNK`` steps while a column is
    live, ``k`` steps at most; returns the new state."""
    stats = {} if stats is None else stats
    for key in ("steps", "host_reads"):
        stats.setdefault(key, 0)
    program.load(state)
    queued = 0
    while queued < k:
        stats["host_reads"] += 1
        if not bool(active_columns(program.state).any()):
            break
        n_steps = min(pipelined_bicgsafe.CHUNK, k - queued)
        program.run((False,) * n_steps)
        stats["steps"] += n_steps
        queued += n_steps
    return program.read()


def result_from_state(state: dict) -> SolveResult:
    """Package a state as a :class:`SolveResult` with per-column fields:
    ``x`` (n, m); ``iterations``, ``relres``, ``converged``,
    ``breakdown``, ``status`` (m,); ``residual_history`` (maxiter+1, m)
    when recorded.  A guarded state's typed status is finalised (a column
    still RUNNING past its budget becomes MAXITER); otherwise a column
    still active (an open-loop state mid-flight) has status RUNNING."""
    if "status" in state:
        sts = state["status"]
        running = sts == SolveStatus.RUNNING.value
        sts = torch.where(running & state["converged"],
                          SolveStatus.CONVERGED.value, sts)
        sts = torch.where(running & state["breakdown"] & ~state["converged"],
                          SolveStatus.BREAKDOWN.value, sts)
        sts = torch.where((sts == SolveStatus.RUNNING.value)
                          & (state["iterations"] >= state["col_maxiter"]),
                          SolveStatus.MAXITER.value, sts)
    else:
        sts = torch.where(active_columns(state), SolveStatus.RUNNING.value,
                          classify_status(state["converged"],
                                          state["breakdown"],
                                          state["relres"]))
    return SolveResult(state["x"], state["iterations"], state["relres"],
                       state["converged"], state["breakdown"], state["hist"],
                       sts.to(torch.int32), None)


def solve_batched(matvec: Callable,
                  B: torch.Tensor,
                  X0: Optional[torch.Tensor] = None,
                  *,
                  config: SolverConfig = SolverConfig(),
                  r0_star: Optional[torch.Tensor] = None,
                  substrate: SubstrateLike = "torch",
                  blocked: bool = False,
                  precond: PrecondLike = None,
                  tol=None,
                  stats: Optional[Dict[str, int]] = None) -> SolveResult:
    """Solve A X = B with p-BiCGSafe for all m columns of ``B`` at once.

    ``matvec`` is an operator or a single-vector matvec, lifted to column
    blocks by the substrate (the block ELL kernel on ``"cuda"``).  ``B`` is
    (n, m); ``X0`` optional (n, m); ``r0_star`` an (n,) shadow shared by
    every column or an (n, m) block; ``tol`` a scalar or (m,).  One (9, m)
    dot phase per iteration whatever m is ((11, m) with ``config.guard``),
    plus one for ``||r_0||``.  ``precond`` (a name or a
    :class:`repro_torch.precond.Preconditioner`) runs every column on the
    left-preconditioned system M^{-1} A X = M^{-1} B, the apply composed
    into the block matvec; ``relres``/``tol`` are then in the
    preconditioned norm.  ``blocked=True`` (the sharded solve's) raises
    :class:`NotImplementedError`.
    """
    if B.dim() != 2:
        raise ValueError(f"B must be (n, m); got shape {tuple(B.shape)}")
    if blocked:
        raise _not_ported("solve_batched(blocked=True)")
    sub = get_substrate(substrate)
    bmv, B = wrap_block_preconditioned(sub, sub.as_block_matvec(matvec),
                                       B.contiguous(), precond, matvec)
    state = init_state(bmv, B, X0, config=config, r0_star=r0_star,
                       substrate=sub, tol=tol)
    state = step_chunk(bmv, state, config.maxiter, config=config,
                       substrate=sub, stats=stats)
    return result_from_state(state)
