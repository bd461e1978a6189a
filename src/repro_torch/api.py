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
steps on the CPU.  ``tol`` and ``maxiter`` are not part of a program's
key: the body reads ``tol`` from a constant buffer and the host bounds
the loop, so every override runs the same program (``maxiter`` stays in
the key only with ``record_history``, whose buffer it sizes).
``stats["programs"]`` counts the programs, ``stats["traces"]`` their
builds, ``stats["graphs"]`` the CUDA graphs captured.

Unlike a jitted function, a program holds device memory between calls:
its buffers and its graph pool.  The cache is therefore bounded by bytes
as well (:data:`_SESSION_CACHE_BYTES`): past the budget, the least
recently used sessions release their programs (and the card the memory)
and leave the cache.  A session handed out before keeps working; its
next call builds its programs again.

The cache serves a session only for content that cannot have changed
under it.  A ``jax.Array`` is immutable; a tensor is not, so the port's
bar is the tensor's version counter, which every in-place operation
bumps: a memoized digest, and a cached session, are used only while the
leaves keep the versions they had when they were made.  The one write the
bar does not see is one through memory a tensor shares with something
else (a CPU tensor from ``torch.from_numpy``, written through the numpy
array); the port's own constructors copy (ROADMAP C15).

Distributed solves, as in the JAX package: a session bound to a
:class:`~repro_torch.core.Stencil7Operator` goes onto a mesh with
:meth:`LinearSolver.on_mesh` (a ``torch.distributed`` DeviceMesh or process
group, every rank making the same calls), whose ``solve`` / ``solve_many``
shard the grid by x-slabs (:mod:`repro_torch.core.distributed`: halo
exchange, one all-reduce of the stacked partials per reduction phase) on
programs the session memoizes.

    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("rows",))
    dsolver = repro_torch.make_solver("p-bicgsafe", stencil,
                                      substrate="cuda").on_mesh(mesh)
    res = dsolver.solve(b_grid)             # res.x: this rank's x-slab

Observability, as in the JAX package: ``trace=True`` (a ring of
``maxiter`` rows) or ``trace=N`` (the last N iterations) on ``solve``,
``solve_many`` and a mesh's solves records the per-iteration trace on the
device (``SolveResult.trace``, a :class:`repro_torch.observe
.ConvergenceTrace`; a traced solve is the untraced one bit for bit, and a
program of its own).  ``profile=DIR`` on ``solve``, ``solve_many`` and a
mesh's ``solve`` warms the programs, runs the solve again inside a
``torch.profiler`` window and sets ``last_profile``, a
:class:`repro_torch.observe.ProfileReport` (also ``DIR/profile.json``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import weakref
from collections import OrderedDict
from typing import (Any, Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .core import CHUNKED, SOLVERS, multirhs
from .core._common import SyncCounter, as_reducer
from .core.linear_operator import Stencil7Operator
from .core.pipelined_bicgsafe import solve_chunked
from .core.program import Program
from .core.substrate import SUBSTRATES, SubstrateLike, get_substrate
from .core.types import (DotReduce, SolveResult, SolverConfig,
                         derive_config, per_column, resolve_device)
from .observe import profile as _profile
from .observe.trace import wrap_trace
from .precond.base import (PrecondLike, Preconditioner, resolve_precond,
                           validate_precond_spec)

__all__ = ["LinearSolver", "DistributedSolver", "make_solver", "solve",
           "operator_fingerprint", "clear_session_cache",
           "session_cache_info"]


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


def _program_config(cfg: SolverConfig) -> SolverConfig:
    """``cfg`` as a program key: without ``tol`` (a constant buffer of the
    body) and ``maxiter`` (the host's loop bound), unless the history
    buffer is sized by it."""
    return dataclasses.replace(
        cfg, tol=0.0, maxiter=cfg.maxiter if cfg.record_history else 0)


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
      blocked: the operator is an ``(n, m) -> (n, m)`` block matvec, taken
        as given by the multi-RHS and open-loop entry points (``solve``
        raises).
      stats: ``{"solves", "steps", "rr_steps", "host_reads", "programs",
        "traces", "graphs", "runs"}`` summed over this session's solves and
        open-loop chunks: iterations queued (stopped ones included),
        residual-replacement steps, host reads of the stop flag, programs
        memoized, program builds (the JAX package's retraces), CUDA
        graphs captured and chunks run (on the card, graph replays).
      last_profile: the :class:`~repro_torch.observe.ProfileReport` of the
        latest ``profile=`` call (``None`` before one).
    """

    def __init__(self, method: str, operator, *,
                 precond: PrecondLike = None,
                 substrate: SubstrateLike = "torch",
                 config: SolverConfig = SolverConfig(),
                 device=None,
                 dot_reduce: Optional[DotReduce] = None,
                 blocked: bool = False,
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
        self.blocked = bool(blocked)
        #: the bound reduction hook as given (``None``: the identity)
        self.dot_reduce = dot_reduce
        self._reduce = as_reducer(dot_reduce)
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
                                      "graphs": 0, "runs": 0}
        self._programs: Dict[Hashable, Program] = {}
        self._cache_key: Optional[Tuple] = None
        self._mesh_bindings: Dict[Any, "DistributedSolver"] = {}
        self.last_profile = None

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
            raw = self.operator if self.blocked \
                else self.sub.as_block_matvec(self.operator)
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
        bmv = self.block_matvec                  # binds the M^{-1} apply
        return self._program(key, lambda: multirhs.batched_program(
            bmv, cfg, self.sub, self.stats, device=self.device, key=key,
            prep=self._papply, dot_reduce=self._reduce))

    @property
    def nbytes(self) -> int:
        """The memory this session's own programs hold (:attr:`repro_torch
        .core.program.Program.nbytes`); its mesh bindings' are theirs
        (:attr:`DistributedSolver.nbytes`)."""
        return sum(p.nbytes for p in self._programs.values())

    def release(self) -> bool:
        """Release every program (graphs, pools, buffers), its mesh
        bindings' too, and forget them; the next call builds them again.
        True when one was on the card.  With a mesh binding, every rank
        calls it together."""
        on_card = self._release_own()
        for binding in self._mesh_bindings.values():
            on_card |= binding.release()
        return on_card

    def _release_own(self) -> bool:
        """Release the session's own programs, never a mesh binding's: what
        the cache's evictions release (each rank evicts on its own)."""
        on_card = self.device.type == "cuda" and bool(self._programs)
        for prog in self._programs.values():
            prog.release()
        self._programs.clear()
        return on_card

    def _used(self) -> None:
        """After a call: mark the session most recently used, and keep the
        cache's programs within the byte budget."""
        hit = _SESSIONS.get(self._cache_key)
        if hit is not None and hit[0] is self:
            _SESSIONS.move_to_end(self._cache_key)
        _trim_session_cache(self)

    def _derive(self, tol, maxiter, trace=None) -> SolverConfig:
        """The bound config with a call's overrides; ``trace=True`` sizes
        the ring to the iteration budget (a full record), an int ``N``
        keeps the last N iterations, ``False`` turns it off."""
        cfg = derive_config(self.config, tol, maxiter)
        if trace is not None:
            cap = cfg.maxiter if trace is True else int(trace)
            cfg = dataclasses.replace(cfg, trace_cap=cap)
        return cfg

    @staticmethod
    def _wrap_trace(res: SolveResult) -> SolveResult:
        """The ring's payload as a :class:`~repro_torch.observe
        .ConvergenceTrace` (one copy to the host), when it has one."""
        if res.trace is None:
            return res
        return res._replace(trace=wrap_trace(res.trace))

    def _profiled_run(self, call: Callable[[], SolveResult],
                      profile_dir: str, entry: str) -> SolveResult:
        """Warm ``call``'s programs (their captures stay out of the
        window), learn the kernel map from one eager run, run ``call``
        again inside a profile capture, and keep the analysed report as
        :attr:`last_profile` and ``profile_dir/profile.json``."""
        call()
        with _profile.capture(profile_dir, learn=call) as cap:
            res = call()
        rep = cap.analyze(
            iterations=int(torch.as_tensor(res.iterations).max()) or None,
            label=f"{self.method}/{self.sub.name}/{entry}")
        rep.save(os.path.join(profile_dir, "profile.json"))
        cap.save_kernel_map()
        self.last_profile = rep
        return res

    def _tensor(self, v):
        if v is None:
            return None
        if isinstance(v, np.ndarray) and not v.flags.writeable:
            v = v.copy()            # torch.as_tensor warns on read-only data
        return torch.as_tensor(v, device=self.device)

    def solve(self, b, x0=None, *, tol=None, maxiter=None, r0_star=None,
              trace=None, profile=None) -> SolveResult:
        """Solve A x = b.  ``tol``/``maxiter`` override the bound config;
        ``x0``/``r0_star`` as for the free functions.  ``trace`` (``True``
        or a capacity) records the per-iteration trace
        (``SolveResult.trace``, a :class:`~repro_torch.observe
        .ConvergenceTrace`; p-BiCGSafe, -rr and ssBiCGSafe2, ``None`` for
        the other methods, as in the JAX package); ``profile=DIR`` profiles
        the solve (:attr:`last_profile`)."""
        if self.blocked:
            raise ValueError(
                "this session wraps a block matvec (blocked=True); use "
                "solve_many / the open-loop handles")
        cfg = self._derive(tol, maxiter, trace)
        b = self._tensor(b)
        x0, r0_star = self._tensor(x0), self._tensor(r0_star)
        key = ("solve", _program_config(cfg), x0 is None, r0_star is None,
               tuple(b.shape), b.dtype)
        self.stats["solves"] += 1

        def call() -> SolveResult:
            return solve_chunked(
                CHUNKED[self.method], self.operator, b, x0, config=cfg,
                r0_star=r0_star, substrate=self.sub, precond=self.precond,
                dot_reduce=self._reduce, stats=self.stats,
                program=lambda step: self._program(key, lambda: Program(
                    step, self.device, key, stats=self.stats)))
        res = call() if profile is None \
            else self._profiled_run(call, profile, "solve")
        self._used()
        return self._wrap_trace(res)

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
        .multirhs.result_from_state`).  ``trace`` and ``profile`` as in
        :meth:`solve`; the trace is batched (``.column(j)`` for one
        column's view)."""
        self._require_pbicgsafe("solve_many")
        B = self._as_block(B)
        scalar = maxiter is not None and np.ndim(maxiter) == 0
        cfg = self._derive(None, maxiter if scalar else None, trace)
        if scalar:
            maxiter = None
        key = ("solve_many", _program_config(cfg), X0 is None,
               r0_star is None, tuple(B.shape), B.dtype)
        self.stats["solves"] += 1
        X0, r0_star = self._tensor(X0), self._tensor(r0_star)

        def call() -> SolveResult:
            st = multirhs.init_state(
                self.block_matvec, self._prep(B), X0, config=cfg,
                r0_star=r0_star, substrate=self.sub, tol=tol,
                maxiter=maxiter, dot_reduce=self._reduce)
            return multirhs.result_from_state(multirhs.run_chunks(
                self._batched_program(key, cfg), st, cfg.maxiter,
                self.stats))
        res = call() if profile is None \
            else self._profiled_run(call, profile, "solve_many")
        self._used()
        return self._wrap_trace(res)

    def init(self, B, X0=None, *, tol=None, maxiter=None,
             r0_star=None) -> dict:
        """The per-column Krylov state for ``A X = B`` (open loop)."""
        self._require_pbicgsafe("init")
        return multirhs.init_state(
            self.block_matvec, self._prep(self._as_block(B)),
            self._tensor(X0),
            config=self.config, r0_star=self._tensor(r0_star),
            substrate=self.sub, tol=tol, maxiter=maxiter,
            dot_reduce=self._reduce)

    def _open_loop_program(self, state: dict) -> Program:
        """The program of :meth:`step_chunk` and :meth:`splice_step` (one
        for both) for states of ``state``'s structure."""
        key = ("step_chunk",) + tuple(
            (name, tuple(v.shape), v.dtype) for name, v in state.items())
        return self._batched_program(key, self.config)

    def step_chunk(self, state: dict, k: int, *,
                   one_run: bool = False) -> dict:
        """Advance every live column by up to ``k`` iterations; ``state``
        and every state returned earlier are left as they were.
        ``one_run`` queues the ``k`` steps as one chunk (one graph replay
        on the card) with no host read: the service engine's chunk."""
        self._require_pbicgsafe("step_chunk")
        out = multirhs.run_chunks(self._open_loop_program(state), state,
                                  int(k), self.stats, one_run=one_run)
        self._used()
        return out

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
            maxiter=self.config.maxiter if maxiter is None else maxiter,
            dot_reduce=self._reduce)

    def splice_step(self, state: dict, refill, B_new, tol, maxiter,
                    k: int, *, one_run: bool = False) -> dict:
        """:meth:`splice`, then :meth:`step_chunk` of ``k``, fused: the
        splice is the first step of the first chunk of :meth:`step_chunk`'s
        program, its mask, block and budgets that program's constants, so
        admission costs no run or host read of its own.  ``B_new`` may lie
        on the host (a numpy array or a CPU tensor): it is copied to the
        card once, into the program's constant buffer, which holds its
        transpose, one right-hand side per row (an (n, m) host block whose
        transpose is contiguous copies as it lies).  ``one_run`` as in
        :meth:`step_chunk`."""
        self._require_pbicgsafe("splice_step")
        m = state["r"].shape[1]
        if isinstance(B_new, (list, tuple)):
            Bt = torch.stack([torch.as_tensor(c) for c in B_new])
        else:
            if isinstance(B_new, np.ndarray) and not B_new.flags.writeable:
                B_new = B_new.copy()
            B_new = torch.as_tensor(B_new)
            if B_new.dim() != 2:
                raise ValueError(f"B_new must be (n, {m}); got shape "
                                 f"{tuple(B_new.shape)}")
            Bt = B_new.t().contiguous()
        if Bt.shape[0] != m:
            raise ValueError(f"B_new must be (n, {m}); got shape "
                             f"{tuple(Bt.t().shape)}")
        dev = state["r"].device
        consts = dict(
            refill=torch.as_tensor(refill).to(dev, torch.bool),
            Bt=Bt,
            tol=per_column(self.config.tol if tol is None else tol, m,
                           state["tol"].dtype, name="tol", device=dev),
            maxiter=per_column(self.config.maxiter if maxiter is None
                               else maxiter, m, torch.int32,
                               name="maxiter", device=dev))
        out = multirhs.run_chunks(self._open_loop_program(state), state,
                                  int(k), self.stats, consts=consts,
                                  one_run=one_run)
        self._used()
        return out

    def result(self, state: dict) -> SolveResult:
        """Package an open-loop state as a :class:`SolveResult`.  Open-loop
        tracing is the bound config's (``SolverConfig(trace_cap=...)``):
        every chunk carries the ring, wrapped here as a batched
        :class:`~repro_torch.observe.ConvergenceTrace`."""
        return self._wrap_trace(multirhs.result_from_state(state))

    def verify_contracts(self, *, bindings: Optional[Sequence[str]] = None,
                         mesh=None, m: int = 3,
                         contracts: Optional[Sequence[str]] = None,
                         raise_on_violation: bool = False):
        """Statically verify the paper's communication contracts on THIS
        session's bindings: tracing only (``make_fx`` in fake mode), no
        solve runs and no kernel launches.

        Traces the step of this session's method with its matvec, its
        bound preconditioner, its substrate and its config through
        :mod:`repro_torch.analysis` and runs the contract passes (one
        fused reduction per iteration, overlap-edge freedom, kernel
        backing, dtype flow; plus the single-all-reduce pass when ``mesh=``
        is given and the operator is a stencil).

        Args:
          bindings: binding kinds to trace (``"single"``: :meth:`solve`'s
            step; ``"batched"``: :meth:`solve_many`'s; ``"open_loop"``:
            the open-loop chunk's); default: ``["batched"]`` for
            p-BiCGSafe sessions (the multi-RHS front door), else
            ``["single"]``.
          mesh: a DeviceMesh or process group: adds the sharded ``"mesh"``
            cell (every rank calls together; see
            :meth:`DistributedSolver.verify_contracts`).
          m: the column count of the batched cells.
          contracts: names from :data:`repro_torch.analysis.PASSES` to run
            (default: all applicable).
          raise_on_violation: raise ``ValueError`` listing the violated
            contracts instead of returning reports that carry them.

        Returns:
          a list of :class:`repro_torch.analysis.ContractReport`, one per
          traced binding.
        """
        from .analysis import run_passes, trace_binding
        if bindings is None:
            bindings = ["batched"] if (self.method == "p-bicgsafe"
                                       or self.blocked) else ["single"]
        bindings = list(bindings)
        if mesh is not None and "mesh" not in bindings:
            bindings.append("mesh")
        reports = []
        for binding in bindings:
            # a mesh builds its preconditioner from the shard's own slab
            precond = self.precond_spec if binding == "mesh" \
                else self.precond
            reports.append(run_passes(trace_binding(
                self.method, self.operator, binding=binding,
                substrate=self.sub, precond=precond,
                guard=self.config.guard, m=m, config=self.config,
                mesh=mesh if binding == "mesh" else None,
                blocked=self.blocked, device=self.device), names=contracts))
        if raise_on_violation:
            _raise_violations(reports)
        return reports

    def on_mesh(self, mesh, *, shard_axes: Optional[Sequence[str]] = None
                ) -> "DistributedSolver":
        """Bind this session to a mesh (a ``torch.distributed`` DeviceMesh
        or process group; every rank calls it): returns a
        :class:`DistributedSolver` whose solves shard the grid by x-slabs
        (halo-exchange matvec, one all-reduce of the stacked partials per
        reduction phase) on programs the binding memoizes.

        The binding is memoized per ``(mesh, shard_axes)``, so calling
        ``on_mesh`` in a loop reuses its programs.  A custom ``dot_reduce``
        cannot be honoured here (the driver brings its own all-reduce), so
        binding one raises rather than drops it."""
        if self.dot_reduce is not None:
            raise ValueError(
                "this session binds a custom dot_reduce, which the "
                "distributed driver replaces with its own all-reduce; "
                "bind the session without dot_reduce= to use .on_mesh")
        from .core.distributed import check_mesh
        check_mesh(mesh)
        key = (mesh, None if shard_axes is None else tuple(shard_axes))
        hit = self._mesh_bindings.get(key)
        if hit is None:
            hit = self._mesh_bindings[key] = DistributedSolver(
                self, mesh, shard_axes)
        return hit


class DistributedSolver:
    """A session bound to a mesh: sharded solves from the same front door.

    Wraps :func:`repro_torch.core.distributed.build_stencil_solver` /
    ``build_stencil_solver_batched``, memoizing the built solves per
    program configuration (``tol`` and ``maxiter`` run the same one).  The
    operator must be a :class:`~repro_torch.core.Stencil7Operator` (the
    row-sharded halo format); a name-spec preconditioner is built
    shard-locally, an instance passed through.  On the card each chunk is
    a CUDA graph with the NCCL all-reduce captured in it.

    The programs live in this binding, outside the session cache's byte
    budget: no rank ever releases them on its own (a rebuild runs its
    first chunk eagerly, collectives included, which the other ranks
    would not pair).  They go with :meth:`release` (or the session's),
    which every rank calls together, as it makes every call here.

    Attributes:
      syncs: the :class:`~repro_torch.core._common.SyncCounter` of the
        binding's all-reduces: its ``calls`` count the reductions started
        (a graph replay adds what its capture started), its ``shapes``
        their shapes.
    """

    def __init__(self, session: LinearSolver, mesh,
                 shard_axes: Optional[Sequence[str]] = None):
        if not isinstance(session.operator, Stencil7Operator):
            raise TypeError(
                "on_mesh requires a Stencil7Operator-bound session (the "
                f"row-sharded halo format); got "
                f"{type(session.operator).__name__}")
        self.session = session
        self.mesh = mesh
        self.shard_axes = None if shard_axes is None else tuple(shard_axes)
        self.syncs = SyncCounter()
        self._solves: Dict[Any, Callable] = {}

    def _built(self, key, build) -> Callable:
        fn = self._solves.get(key)
        if fn is None:
            fn = self._solves[key] = build()
        return fn

    def solve(self, b_grid, *, tol=None, maxiter=None, trace=None,
              profile=None) -> SolveResult:
        """Sharded single-RHS solve of the bound method: ``b_grid`` is the
        global ``(nx, ny, nz)`` grid (on every rank); ``x`` of the result
        is this rank's slab, every other field equal on all ranks.
        ``trace`` as in :meth:`LinearSolver.solve`: the ring is built from
        the all-reduced dots, the same on every rank, and adds no
        collective; ``profile=DIR`` as there (every rank profiles its own
        part; the report goes to the session's ``last_profile``)."""
        from .core.distributed import build_stencil_solver
        s = self.session
        cfg = s._derive(tol, maxiter, trace)
        fn = self._built(("dsolve", _program_config(cfg)),
                         lambda: build_stencil_solver(
                             SOLVERS[s.method], s.operator, self.mesh,
                             shard_axes=self.shard_axes, config=cfg,
                             substrate=s.sub, precond=s.precond_spec,
                             stats=s.stats, syncs=self.syncs))
        s.stats["solves"] += 1

        def call() -> SolveResult:
            return fn(b_grid, tol=cfg.tol, maxiter=cfg.maxiter)
        res = call() if profile is None \
            else s._profiled_run(call, profile, "mesh_solve")
        s._used()
        return s._wrap_trace(res)

    def solve_many(self, B_grid, *, tol=None, maxiter=None,
                   trace=None) -> SolveResult:
        """Sharded batched solve: ``(nx, ny, nz, m)`` right-hand sides, one
        ``(9, m)`` all-reduce per iteration whatever m is (``(11, m)``
        with ``SolverConfig(guard=True)``); ``x`` is this rank's
        ``(nx // shards, ny, nz, m)`` slab.  ``trace`` as in :meth:`solve`
        (batched)."""
        s = self.session
        s._require_pbicgsafe("on_mesh(...).solve_many")
        from .core.distributed import build_stencil_solver_batched
        cfg = s._derive(tol, maxiter, trace)
        fn = self._built(("dsolve_many", _program_config(cfg)),
                         lambda: build_stencil_solver_batched(
                             s.operator, self.mesh,
                             shard_axes=self.shard_axes, config=cfg,
                             substrate=s.sub, precond=s.precond_spec,
                             stats=s.stats, syncs=self.syncs))
        s.stats["solves"] += 1
        res = fn(B_grid, tol=cfg.tol, maxiter=cfg.maxiter)
        s._used()
        return s._wrap_trace(res)

    def verify_contracts(self, *, m: int = 3,
                         contracts: Optional[Sequence[str]] = None,
                         raise_on_violation: bool = False):
        """:meth:`LinearSolver.verify_contracts` of the ``"mesh"`` cell on
        this binding's mesh: the sharded step (halo matvec, shard-local
        preconditioner, the all-reduce) traced in fake mode, with the
        single-all-reduce pass.  Building the sharded solve makes one
        all-reduce, so every rank calls it together.  Returns a list of
        one :class:`repro_torch.analysis.ContractReport`."""
        from .analysis import run_passes, trace_binding
        s = self.session
        reports = [run_passes(trace_binding(
            s.method, s.operator, binding="mesh", substrate=s.sub,
            precond=s.precond_spec, guard=s.config.guard, m=m,
            config=s.config, mesh=self.mesh, shard_axes=self.shard_axes,
            device=s.device), names=contracts)]
        if raise_on_violation:
            _raise_violations(reports)
        return reports

    @property
    def nbytes(self) -> int:
        """The memory this binding's programs hold."""
        return sum(p.nbytes for fn in self._solves.values()
                   for p in fn.programs.values())

    def release(self) -> bool:
        """Release every program of this binding (every rank together);
        the next call builds them again.  True when one was on the card."""
        on_card = False
        for fn in self._solves.values():
            for prog in fn.programs.values():
                on_card |= prog.device.type == "cuda"
                prog.release()
            fn.programs.clear()
        return on_card


def _raise_violations(reports) -> None:
    bad = [(r.spec.label, f) for r in reports for f in r.violations]
    if bad:
        raise ValueError(
            "contract violation(s) on this session's bindings:\n"
            + "\n".join(f"  {label}: {f.contract} — {f.detail}"
                        for label, f in bad))


# ---------------------------------------------------------------------------
# the session cache
# ---------------------------------------------------------------------------

#: LRU-bounded: a long-running process whose operator content evolves
#: (time-stepping one-shots through :func:`solve`) must not pin every
#: earlier operator and its programs (their buffers and CUDA graph pools)
#: until the card runs out of memory.  A session handed out keeps working
#: after eviction; it is only no longer found by content.
_SESSION_CACHE_MAX = 64
#: the bytes the cached sessions' programs may hold together; past it the
#: least recently used sessions release their programs and leave the
#: cache.  ``None``: half the memory of the card the newest call ran on
#: (no byte bound for sessions on the CPU).
_SESSION_CACHE_BYTES: Optional[int] = None
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
                dot_reduce: Optional[DotReduce] = None,
                blocked: bool = False,
                recovery=None,
                scenario=None):
    """Bind ``method`` (a name from :data:`repro_torch.core.SOLVERS`) to
    ``operator`` (Dense/CSR/ELL/Stencil7, a dense matrix, or a matvec
    callable) on ``device`` (``None`` means ``"cuda"``).

    ``dot_reduce``: a reduction hook, ``partials -> reduced``, applied to
    every phase of inner products (the JAX package's; a session with one
    is never cached: a callable is not content-addressable).  ``blocked``:
    ``operator`` is already an ``(n, m) -> (n, m)`` block matvec
    (multi-RHS and open-loop entry points only: the session analogue of
    ``solve_batched(blocked=True)``).

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
    built per call around the cached guarded session.

    ``scenario``: a registered scenario name or a :class:`repro_torch
    .scenarios.Scenario`, which declares the operator (built through its
    plugin on ``device``, once), method, precond, substrate, config and
    recovery: no other argument but ``device`` may be given with it.  A
    repeat call returns the same session."""
    if scenario is not None:
        # lazy: a scenario binds through this function
        from .scenarios import resolve_scenario
        if operator is not None or method != "p-bicgsafe" \
                or precond is not None or substrate != "torch" \
                or config != SolverConfig() or dot_reduce is not None \
                or blocked or recovery is not None:
            raise TypeError(
                "make_solver(scenario=...) is exclusive: the scenario "
                "declares the operator, method, precond, substrate, "
                "config and recovery; pass nothing else but device=")
        return resolve_scenario(scenario).bind(device)
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
                            device=device, dot_reduce=dot_reduce,
                            blocked=blocked)
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
    if fingerprint is not None and versions is not None and name is not None \
            and dot_reduce is None and not blocked:
        key = (method, fingerprint, name, config, dev)
        hit = _SESSIONS.get(key)
        if hit is not None:
            if hit[1] == _bound_versions(hit[0].operator,
                                         hit[0].precond_spec):
                _SESSIONS.move_to_end(key)
                return hit[0]
            del _SESSIONS[key]     # its tensors were written in place
    session = LinearSolver(method, operator, precond=precond, substrate=sub,
                           config=config, device=dev, dot_reduce=dot_reduce,
                           blocked=blocked, fingerprint=fingerprint)
    if key is not None:
        session._cache_key = key
        _SESSIONS[key] = (session, versions)
        evicted = []
        while len(_SESSIONS) > _SESSION_CACHE_MAX:
            evicted.append(_SESSIONS.popitem(last=False)[1][0])
        _release(evicted)
    return session


def solve(A, b, method: str = "p-bicgsafe", *, x0=None, tol=None,
          maxiter=None, r0_star=None, precond: PrecondLike = None,
          substrate: SubstrateLike = "torch",
          config: SolverConfig = SolverConfig(),
          device=None,
          dot_reduce: Optional[DotReduce] = None) -> SolveResult:
    """One-shot convenience: ``repro_torch.solve(A, b)`` (``precond=`` and
    ``dot_reduce=`` as in :func:`make_solver`).  It goes through the
    session cache, so a second call against equal content reuses the
    session's programs."""
    session = make_solver(method, A, precond=precond, substrate=substrate,
                          config=config, device=device,
                          dot_reduce=dot_reduce)
    return session.solve(b, x0, tol=tol, maxiter=maxiter, r0_star=r0_star)


def _release(sessions) -> None:
    """Release the programs of ``sessions``; what they held on the card
    goes back to it."""
    on_card = False
    for sess in sessions:
        on_card |= sess._release_own()
    if on_card:
        torch.cuda.empty_cache()


def _cache_budget(session: LinearSolver) -> Optional[int]:
    if _SESSION_CACHE_BYTES is not None:
        return _SESSION_CACHE_BYTES
    if session.device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(session.device).total_memory // 2


def _trim_session_cache(session: LinearSolver) -> None:
    """Keep the cached sessions' program bytes within the budget: release
    the least recently used sessions' programs and drop those sessions,
    never ``session`` (the one just used)."""
    budget = _cache_budget(session)
    if budget is None:
        return
    total = sum(s.nbytes for s, _ in _SESSIONS.values())
    evicted = []
    for key in list(_SESSIONS):
        if total <= budget:
            break
        sess = _SESSIONS[key][0]
        if sess is session:
            continue
        total -= sess.nbytes
        evicted.append(sess)
        del _SESSIONS[key]
    _release(evicted)


def clear_session_cache() -> None:
    """Drop every cached session (tests; memory pressure: each holds its
    programs' buffers and CUDA graph pools)."""
    _SESSIONS.clear()


def session_cache_info() -> Dict[str, int]:
    """The cached sessions, their programs and the bytes those hold."""
    sessions = [s for s, _ in _SESSIONS.values()]
    return {"sessions": len(sessions),
            "programs": sum(len(s._programs) for s in sessions),
            "bytes": sum(s.nbytes for s in sessions)}
