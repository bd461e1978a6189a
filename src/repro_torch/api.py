"""repro_torch.api — the front door: bind-once ``LinearSolver`` sessions
(PyTorch port of ``repro.api``).

    import repro_torch

    solver = repro_torch.make_solver("p-bicgsafe", op, substrate="cuda")
    res = solver.solve(b)                   # on the card
    many = solver.solve_many(B)             # B (n, m): all columns at once
    res = repro_torch.solve(op, b)          # one-shot

    st = solver.init(B, tol=1e-6)           # open loop, what a service drives
    st = solver.step_chunk(st, 16)
    st = solver.splice(st, refill, B_new)   # refill finished columns
    res = solver.result(st)

    guarded = repro_torch.make_solver("p-bicgsafe", op, substrate="cuda",
                                      recovery=RecoveryPolicy(chunk=16))
    res = guarded.solve_many(B)             # typed statuses, recovery

``device=None`` means ``"cuda"``, and raises when no GPU is present: pass
``device="cpu"`` to run on the CPU.  The operator's tensors must lie on the
session's device.

    pre = repro_torch.make_solver("p-bicgsafe", op, substrate="cuda",
                                  precond="block_jacobi")
    res = pre.solve(b)                      # M^{-1} A x = M^{-1} b

``precond=`` (``None``, a name of :data:`repro_torch.precond
.PRECONDITIONERS` or a :class:`repro_torch.precond.Preconditioner`) is
checked when the session is made and built on first use, once; every
solve of the session, single, batched and open-loop, then runs on the
left-preconditioned system, whose residual ``relres``/``tol`` measure.

Sessions and programs, as in the JAX package.  :func:`make_solver` (and
so :func:`solve`) returns the same session for operators of equal content
(:func:`operator_fingerprint`: class, static fields and tensor bytes),
from an LRU cache of :data:`_SESSION_CACHE_MAX` sessions
(:func:`clear_session_cache`, :func:`session_cache_info`).  A session
memoizes one program per (entry point, derived config, argument
structure, shapes and type): the counterpart of ``jax.jit``, a
:class:`repro_torch.core.program.Program` whose solver chunks are CUDA
graphs on the card (captured on first use, then replayed) and the eager
steps on the CPU.  ``stats["programs"]`` counts the programs,
``stats["traces"]`` their builds, ``stats["graphs"]`` the CUDA graphs
captured.

The cache serves a session only for content that cannot have changed
under it.  A ``jax.Array`` is immutable; a tensor is not, so the port's
bar is the tensor's version counter, which every in-place operation
bumps: a memoized digest, and a cached session, are used only while the
leaves keep the versions they had when they were made.  The one write the
bar does not see is one through memory a tensor shares with something
else (a CPU tensor from ``torch.from_numpy``, written through the numpy
array); the port's own constructors copy (ROADMAP C15).

Not ported yet, and raising :class:`NotImplementedError`: ``trace=`` and
``profile=`` of ``solve`` and ``solve_many``, and ``on_mesh``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from .core import CHUNKED, SOLVERS, multirhs
from .core.pipelined_bicgsafe import solve_chunked
from .core.program import Program
from .core.substrate import SUBSTRATES, SubstrateLike, get_substrate
from .core.types import SolveResult, SolverConfig, resolve_device
from .precond.base import (PrecondLike, Preconditioner, resolve_precond,
                           validate_precond_spec)

__all__ = ["LinearSolver", "make_solver", "solve", "operator_fingerprint",
           "clear_session_cache", "session_cache_info"]


# ---------------------------------------------------------------------------
# content fingerprints
# ---------------------------------------------------------------------------

_STATIC = (int, float, complex, bool, str, bytes, type(None))

#: per-object digest memo: id -> (weakref guarding id reuse, the leaves'
#: versions, digest).  A hit needs the same live object with every tensor
#: leaf at the version it had when it was hashed; the weakref's callback
#: drops the entry when the object dies, so a recycled id never aliases.
_CONTENT_DIGESTS: Dict[int, Tuple[Any, Tuple[int, ...], str]] = {}


def _flatten(obj, spec: List[str], leaves: List[torch.Tensor],
             owner: str) -> None:
    """The tensor leaves of ``obj`` (a tensor, a dataclass of them, or a
    tuple / list), with the structure and static fields written to
    ``spec`` (what the JAX package's treedef carries)."""
    if isinstance(obj, torch.Tensor):
        spec.append("*")
        leaves.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        spec.append(f"{type(obj).__name__}(")
        for f in dataclasses.fields(obj):
            spec.append(f"{f.name}=")
            _flatten(getattr(obj, f.name), spec, leaves, owner)
        spec.append(")")
    elif isinstance(obj, (tuple, list)):
        spec.append(f"{type(obj).__name__}[")
        for item in obj:
            _flatten(item, spec, leaves, owner)
        spec.append("]")
    elif isinstance(obj, _STATIC):
        spec.append(repr(obj))
    else:
        raise TypeError(
            f"cannot fingerprint non-array content of type "
            f"{type(obj).__name__} (in {owner}); content-addressed caching "
            "needs operators made of tensors")


def _leaves(obj) -> List[torch.Tensor]:
    leaves: List[torch.Tensor] = []
    _flatten(obj, [], leaves, type(obj).__name__)
    return leaves


def _versions(leaves) -> Optional[Tuple[int, ...]]:
    """The leaves' version counters; ``None`` when one has none (an
    inference tensor), whose content the bar cannot watch."""
    if any(t.is_inference() for t in leaves):
        return None
    return tuple(t._version for t in leaves)


def _content_digest(obj) -> str:
    """sha256 of ``obj``'s class, structure, static fields and tensor
    leaves (dtype, shape, bytes; each leaf copied to the host once).

    Memoized per live object while its leaves keep their versions: repeat
    fingerprinting of the same operator (every :func:`solve` call of a
    time-stepping loop) must not copy and hash all of it again to find a
    cache hit."""
    spec: List[str] = []
    leaves: List[torch.Tensor] = []
    _flatten(obj, spec, leaves, type(obj).__name__)
    versions = _versions(leaves)
    key = id(obj)
    hit = _CONTENT_DIGESTS.get(key)
    if hit is not None and hit[0]() is obj and versions is not None \
            and hit[1] == versions:
        return hit[2]
    h = hashlib.sha256()
    h.update(type(obj).__name__.encode())
    h.update("".join(spec).encode())
    for leaf in leaves:
        h.update(str(leaf.dtype).encode())
        h.update(str(tuple(leaf.shape)).encode())
        host = leaf.detach().reshape(-1).contiguous().cpu()
        h.update(host.view(torch.uint8).numpy().data)
    digest = h.hexdigest()
    if versions is None:
        return digest               # untracked leaves: never memoize
    try:
        ref = weakref.ref(obj, lambda _, k=key: _CONTENT_DIGESTS.pop(k, None))
    except TypeError:
        return digest               # unweakrefable: no memo
    _CONTENT_DIGESTS[key] = (ref, versions, digest)
    return digest


def operator_fingerprint(op, precond: PrecondLike = None) -> str:
    """Content hash identifying an operator (and optionally a precond spec).

    Two operator objects with the same class, static fields and tensor
    contents hash alike: the key under which sessions (a built
    preconditioner and the memoized programs) are shared across
    :func:`make_solver` calls and :func:`solve` one-shots.  ``precond``
    folds a name spec or a built :class:`~repro_torch.precond
    .Preconditioner` (by its own contents) into the key.

    Raises ``TypeError`` for content that is not made of tensors (a bare
    matvec callable): an identity-based hash would alias after garbage
    collection, so such operators are not cached.
    """
    h = hashlib.sha256()
    h.update(b"op:")
    h.update(_content_digest(op).encode())
    if precond is not None:
        if isinstance(precond, str):
            h.update(f"precond-name:{precond}".encode())
        else:
            h.update(b"precond:")
            h.update(_content_digest(precond).encode())
    return h.hexdigest()


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet")


def _operator_device(op) -> Optional[torch.device]:
    if isinstance(op, torch.Tensor):
        return op.device
    return getattr(op, "device", None)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _check_device(operator, device: torch.device) -> None:
    op_device = _operator_device(operator)
    if op_device is not None and not _same_device(op_device, device):
        raise ValueError(f"the operator lies on {op_device}, the session "
                         f"on {device}")


class LinearSolver:
    """One method bound to one operator: build once, solve many times.

    Attributes:
      method / operator / config / device: as bound.
      sub: the resolved :class:`~repro_torch.core.substrate.Substrate`.
      precond_spec: the ``precond=`` spec as given; ``precond`` the built
        preconditioner (``None`` when unset), built on first access.
      block_matvec: the substrate's ``(n, m)`` block matvec of the operator
        (the block ELL kernel on ``"cuda"``), composed once with the bound
        M^{-1}-apply when there is a preconditioner.
      fingerprint: the content hash the session is cached under
        (:func:`operator_fingerprint`; ``None`` for a bare callable, whose
        sessions are never cached).
      stats: ``{"solves", "steps", "rr_steps", "host_reads", "programs",
        "traces", "graphs"}`` summed over this session's solves and
        open-loop chunks: iterations queued (stopped ones included),
        residual-replacement steps, host reads of the stop flag, programs
        memoized, program builds (the JAX package's retraces) and CUDA
        graphs captured.
    """

    def __init__(self, method: str, operator, *,
                 precond: PrecondLike = None,
                 substrate: SubstrateLike = "torch",
                 config: SolverConfig = SolverConfig(),
                 device=None,
                 fingerprint: Optional[str] = None):
        if method not in SOLVERS:
            raise ValueError(f"unknown method {method!r}; expected one of "
                             f"{sorted(SOLVERS)}")
        self.method = method
        self.operator = operator
        self.config = config
        self.device = resolve_device(device)
        _check_device(operator, self.device)
        self.sub = get_substrate(substrate)
        # checked now (a bad spec fails at make_solver), built on first use:
        # a block-Jacobi build at full size takes seconds
        validate_precond_spec(precond, operator)
        self.precond_spec = precond
        self._precond_built = False
        self._precond: Optional[Preconditioner] = None
        self._bmv: Optional[Callable] = None
        self._papply: Optional[Callable] = None
        self.fingerprint = fingerprint
        self.stats: Dict[str, int] = {"solves": 0, "steps": 0,
                                      "rr_steps": 0, "host_reads": 0,
                                      "programs": 0, "traces": 0,
                                      "graphs": 0}
        self._programs: Dict[Hashable, Program] = {}

    @property
    def precond(self) -> Optional[Preconditioner]:
        """The built preconditioner (the first access builds it, once)."""
        if not self._precond_built:
            self._precond = resolve_precond(self.precond_spec, self.operator)
            self._precond_built = True
        return self._precond

    @property
    def block_matvec(self) -> Callable:
        """The substrate's block matvec, composed once with M^{-1}."""
        if self._bmv is None:
            raw = self.sub.as_block_matvec(self.operator)
            pc = self.precond
            if pc is None:
                self._bmv = raw
            else:
                papply = self.sub.as_precond_apply(pc)
                self._papply = papply
                self._bmv = lambda X: papply(raw(X))
        return self._bmv

    def _prep(self, B: torch.Tensor) -> torch.Tensor:
        """``M^{-1} B``: the right-hand sides of the preconditioned system
        (``B`` itself without a preconditioner)."""
        self.block_matvec                 # composes, and binds the apply
        return B if self._papply is None else self._papply(B)

    def __repr__(self):
        # the spec, not the property: a repr must not trigger the build
        pc = getattr(self._precond, "name", None) if self._precond_built \
            else self.precond_spec
        return (f"<LinearSolver {self.method!r} substrate={self.sub.name!r} "
                f"precond={pc!r} device={str(self.device)!r}>")

    def _program(self, key: Hashable, build: Callable[[], Program]
                 ) -> Program:
        """The memoized program of ``key``, built on its first use."""
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = build()
            self.stats["programs"] += 1
            self.stats["traces"] += 1
        return prog

    def _batched_program(self, key: Hashable, cfg: SolverConfig) -> Program:
        return self._program(key, lambda: multirhs.batched_program(
            self.block_matvec, cfg, self.sub, self.stats,
            device=self.device, key=key))

    def _derive(self, tol, maxiter) -> SolverConfig:
        cfg = self.config
        if tol is not None:
            cfg = dataclasses.replace(cfg, tol=float(tol))
        if maxiter is not None:
            cfg = dataclasses.replace(cfg, maxiter=int(maxiter))
        return cfg

    def _tensor(self, v):
        if v is None:
            return None
        if isinstance(v, np.ndarray) and not v.flags.writeable:
            v = v.copy()            # torch.as_tensor warns on read-only data
        return torch.as_tensor(v, device=self.device)

    def solve(self, b, x0=None, *, tol=None, maxiter=None, r0_star=None,
              trace=None, profile=None) -> SolveResult:
        """Solve A x = b.  ``tol``/``maxiter`` override the bound config;
        ``x0``/``r0_star`` as for the free functions."""
        if trace:
            raise _not_ported("solve(trace=...)")
        if profile is not None:
            raise _not_ported("solve(profile=...)")
        cfg = self._derive(tol, maxiter)
        b = self._tensor(b)
        key = ("solve", cfg, x0 is None, r0_star is None, tuple(b.shape),
               b.dtype)
        self.stats["solves"] += 1
        return solve_chunked(
            CHUNKED[self.method], self.operator, b, self._tensor(x0),
            config=cfg, r0_star=self._tensor(r0_star), substrate=self.sub,
            precond=self.precond, stats=self.stats,
            program=lambda step: self._program(key, lambda: Program(
                step, self.device, key, stats=self.stats)))

    # -- multi-RHS and the open-loop handles -------------------------------

    def _require_pbicgsafe(self, what: str) -> None:
        """The batched iteration is p-BiCGSafe: a session bound to another
        method must not run it under its own name."""
        if self.method != "p-bicgsafe":
            raise ValueError(
                f"{what} runs the batched p-BiCGSafe iteration only (this "
                f"session is bound to {self.method!r}); bind a "
                '"p-bicgsafe" session for multi-RHS / open-loop solves, or '
                "use .solve per right-hand side")

    def _as_block(self, B) -> torch.Tensor:
        """An (n, m) block, or a sequence of (n,) columns, as a contiguous
        (n, m) tensor on the session's device."""
        if isinstance(B, (list, tuple)):
            B = torch.stack([self._tensor(c) for c in B], dim=1)
        else:
            B = self._tensor(B)
        if B.dim() != 2:
            raise ValueError(f"B must be (n, m) or a sequence of (n,) "
                             f"columns; got shape {tuple(B.shape)}")
        return B.contiguous()

    def solve_many(self, B, X0=None, *, tol=None, maxiter=None,
                   r0_star=None, trace=None, profile=None) -> SolveResult:
        """Solve A X = B for all columns at once: one (9, m) reduction per
        iteration.  ``B`` is (n, m) or a sequence of (n,) columns; ``tol``
        and ``maxiter`` are scalars or (m,).  A scalar ``maxiter`` also
        bounds the loop; (m,) budgets are capped by ``config.maxiter``.
        The result's fields are per column (see :func:`repro_torch.core
        .multirhs.result_from_state`)."""
        self._require_pbicgsafe("solve_many")
        if trace:
            raise _not_ported("solve_many(trace=...)")
        if profile is not None:
            raise _not_ported("solve_many(profile=...)")
        B = self._as_block(B)
        if maxiter is not None and np.ndim(maxiter) == 0:
            cfg, maxiter = self._derive(None, maxiter), None
        else:
            cfg = self.config
        key = ("solve_many", cfg, X0 is None, r0_star is None,
               tuple(B.shape), B.dtype)
        self.stats["solves"] += 1
        st = multirhs.init_state(
            self.block_matvec, self._prep(B), self._tensor(X0), config=cfg,
            r0_star=self._tensor(r0_star), substrate=self.sub, tol=tol,
            maxiter=maxiter)
        st = multirhs.run_chunks(self._batched_program(key, cfg), st,
                                 cfg.maxiter, self.stats)
        return multirhs.result_from_state(st)

    def init(self, B, X0=None, *, tol=None, maxiter=None,
             r0_star=None) -> dict:
        """The per-column Krylov state for ``A X = B`` (open loop)."""
        self._require_pbicgsafe("init")
        return multirhs.init_state(
            self.block_matvec, self._prep(self._as_block(B)),
            self._tensor(X0),
            config=self.config, r0_star=self._tensor(r0_star),
            substrate=self.sub, tol=tol, maxiter=maxiter)

    def step_chunk(self, state: dict, k: int) -> dict:
        """Advance every live column by up to ``k`` iterations; ``state``
        and every state returned earlier are left as they were."""
        self._require_pbicgsafe("step_chunk")
        key = ("step_chunk",) + tuple(
            (name, tuple(v.shape), v.dtype) for name, v in state.items())
        return multirhs.run_chunks(self._batched_program(key, self.config),
                                   state, int(k), self.stats)

    def splice(self, state: dict, refill, B_new, *, tol=None, maxiter=None,
               r0_star=None) -> dict:
        """Refill the ``refill`` columns with fresh right-hand sides from
        ``B_new`` mid-flight; the other columns are left untouched.  The
        fresh columns' ``tol`` / ``maxiter`` default to the bound config's."""
        self._require_pbicgsafe("splice")
        return multirhs.splice_columns(
            self.block_matvec, state, self._tensor(refill),
            self._prep(self._as_block(B_new)), r0_star=self._tensor(r0_star),
            substrate=self.sub,
            tol=self.config.tol if tol is None else tol,
            maxiter=self.config.maxiter if maxiter is None else maxiter)

    def splice_step(self, state: dict, refill, B_new, tol, maxiter,
                    k: int) -> dict:
        """:meth:`splice`, then :meth:`step_chunk` of ``k``."""
        self._require_pbicgsafe("splice_step")
        state = self.splice(state, refill, B_new, tol=tol, maxiter=maxiter)
        return self.step_chunk(state, k)

    def result(self, state: dict) -> SolveResult:
        """Package an open-loop state as a :class:`SolveResult`."""
        return multirhs.result_from_state(state)

    def on_mesh(self, *args, **kwargs):
        raise _not_ported("on_mesh (distributed solves)")


# ---------------------------------------------------------------------------
# the session cache
# ---------------------------------------------------------------------------

#: LRU-bounded: a long-running process whose operator content evolves
#: (time-stepping one-shots through :func:`solve`) must not pin every
#: earlier operator and its programs (their buffers and CUDA graph pools)
#: until the card runs out of memory.  A session handed out keeps working
#: after eviction; it is only no longer found by content.
_SESSION_CACHE_MAX = 64
#: key -> (session, the versions of its bound tensors when it was made)
_SESSIONS: "OrderedDict[Tuple, Tuple[LinearSolver, Tuple[int, ...]]]" = \
    OrderedDict()


def _substrate_cache_name(sub) -> Optional[str]:
    """Registry substrates are cacheable by name; other instances are not
    (their behaviour is not content-addressable)."""
    name = getattr(sub, "name", None)
    return name if SUBSTRATES.get(name) is sub else None


def _bound_versions(operator, precond) -> Optional[Tuple[int, ...]]:
    """The version counters of every tensor a session binds (the
    operator's and a built preconditioner's); ``None`` when one is not
    watched (an inference tensor): such a session is not cached."""
    leaves = _leaves(operator)
    if isinstance(precond, Preconditioner):
        leaves += _leaves(precond)
    return _versions(leaves)


def make_solver(method: str = "p-bicgsafe", operator=None, *,
                precond: PrecondLike = None,
                substrate: SubstrateLike = "torch",
                config: SolverConfig = SolverConfig(),
                device=None,
                recovery=None):
    """Bind ``method`` (a name from :data:`repro_torch.core.SOLVERS`) to
    ``operator`` (Dense/CSR/ELL/Stencil7, a dense matrix, or a matvec
    callable) on ``device`` (``None`` means ``"cuda"``).

    ``precond``: ``None``, a name of :data:`repro_torch.precond
    .PRECONDITIONERS` (built from ``operator``, which must then be an
    operator object) or a :class:`repro_torch.precond.Preconditioner`;
    checked here, built on first use, once.  Every solve of the session
    runs on the left-preconditioned system.

    ``recovery``: ``None`` | ``True`` | a :class:`repro_torch.resilience
    .RecoveryPolicy`.  Given one, the result is a :class:`repro_torch
    .resilience.GuardedSolver` around a guarded session (``config.guard``:
    the fused reduction widens to (11, m) health rows) whose chunked
    driver applies the policy; ``True`` means the default policy.
    p-BiCGSafe only.

    Two calls with equal content (operator tensors and static fields,
    precond spec, substrate name, config, method, device) return the same
    session, its built preconditioner and programs reused; a hit is served
    only while the bound tensors keep the versions they had when the
    session was made, and is dropped otherwise.  A guarded wrapper is
    built per call around the cached guarded session."""
    if operator is None:
        raise TypeError("make_solver requires an operator")
    if recovery is not None and recovery is not False:
        # lazy: repro_torch.resilience imports this module for fallbacks
        from .resilience.guard import GuardedSolver, guarded_config
        from .resilience.policy import RecoveryPolicy
        policy = RecoveryPolicy() if recovery is True else recovery
        if not isinstance(policy, RecoveryPolicy):
            raise TypeError(
                f"recovery must be None, True or a RecoveryPolicy; got "
                f"{type(recovery).__name__}")
        inner = make_solver(method, operator, precond=precond,
                            substrate=substrate,
                            config=guarded_config(config, policy),
                            device=device)
        return GuardedSolver(inner, policy)
    if method not in SOLVERS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{sorted(SOLVERS)}")
    sub = get_substrate(substrate)
    dev = resolve_device(device)
    _check_device(operator, dev)
    try:
        fingerprint = operator_fingerprint(operator, precond)
        versions = _bound_versions(operator, precond)
    except TypeError:
        fingerprint = versions = None          # a bare callable
    key = None
    name = _substrate_cache_name(sub)
    if fingerprint is not None and versions is not None and name is not None:
        key = (method, fingerprint, name, config, dev)
        hit = _SESSIONS.get(key)
        if hit is not None:
            if hit[1] == _bound_versions(hit[0].operator,
                                         hit[0].precond_spec):
                _SESSIONS.move_to_end(key)
                return hit[0]
            del _SESSIONS[key]     # its tensors were written in place
    session = LinearSolver(method, operator, precond=precond, substrate=sub,
                           config=config, device=dev,
                           fingerprint=fingerprint)
    if key is not None:
        _SESSIONS[key] = (session, versions)
        while len(_SESSIONS) > _SESSION_CACHE_MAX:
            _SESSIONS.popitem(last=False)
    return session


def solve(A, b, method: str = "p-bicgsafe", *, x0=None, tol=None,
          maxiter=None, r0_star=None, precond: PrecondLike = None,
          substrate: SubstrateLike = "torch",
          config: SolverConfig = SolverConfig(),
          device=None) -> SolveResult:
    """One-shot convenience: ``repro_torch.solve(A, b)`` (``precond=`` as
    in :func:`make_solver`).  It goes through the session cache, so a
    second call against equal content reuses the session's programs."""
    session = make_solver(method, A, precond=precond, substrate=substrate,
                          config=config, device=device)
    return session.solve(b, x0, tol=tol, maxiter=maxiter, r0_star=r0_star)


def clear_session_cache() -> None:
    """Drop every cached session (tests; memory pressure: each holds its
    programs' buffers and CUDA graph pools)."""
    _SESSIONS.clear()


def session_cache_info() -> Dict[str, int]:
    return {"sessions": len(_SESSIONS),
            "programs": sum(len(s._programs) for s, _ in _SESSIONS.values())}
