"""Operator registry: named views onto :mod:`repro_torch.api` solver
sessions (PyTorch port of ``repro.service.registry``).

Serving traffic is repetitive: many requests arrive against the same
operator, often built anew per request.  Deduplication by content, and
what rides on it (the preconditioner built once, the block's program
built and captured once), lives in :func:`repro_torch.api.make_solver`,
which keeps whole sessions under the operator-content fingerprint.  The
registry binds engine-facing names (and the engine's chunk) to those
sessions: two registrations of equal content, in one engine, in two, or
through a direct ``repro_torch.make_solver`` call, share one session and
so one set of programs.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..api import LinearSolver, make_solver, operator_fingerprint
from ..core.types import SolverConfig
from ..precond.base import PrecondLike
from .types import ServiceConfig


class RegisteredOperator:
    """One operator (and optional preconditioner) bound to the engine's
    block: a named, chunk-sized view onto a cached :class:`repro_torch.api
    .LinearSolver` session.

    ``init_fn`` builds a block's state (eager); ``step_fn`` runs one chunk
    and ``splice_step_fn`` one chunk opened by a refill of masked columns,
    both one run of the same program of the session (one graph replay on
    the card) with no host read: the engine reads the flags once after.
    The right-hand sides go in raw; M^{-1} is applied inside.
    """

    def __init__(self, name: str, op, precond: PrecondLike,
                 scfg: ServiceConfig, session: LinearSolver):
        self.name = name
        self.op = op
        self.scfg = scfg
        self.session = session
        self.fingerprint = session.fingerprint
        self.sub = session.sub
        #: the "cuda" substrate launches the hand-written kernels
        self.kernel_backed = bool(session.sub.kernel_backed)
        self.precond = session.precond          # built once, by the session
        self.bmv = session.block_matvec
        self.n = op.shape[0]
        self.dtype = op.dtype
        self.device = session.device

        chunk = int(scfg.chunk)
        self.init_fn = lambda B, tolv, mitv: session.init(
            B, tol=tolv, maxiter=mitv)
        self.step_fn = lambda st: session.step_chunk(st, chunk, one_run=True)
        self.splice_step_fn = lambda st, mask, Bn, tolv, mitv: \
            session.splice_step(st, mask, Bn, tolv, mitv, chunk,
                                one_run=True)

    def __repr__(self):
        pc = getattr(self.precond, "name", None)
        return (f"<RegisteredOperator {self.name!r} n={self.n} "
                f"precond={pc!r} substrate={self.sub.name!r}>")


class OperatorRegistry:
    """Content-addressed operator table (names -> sessions).

    ``register`` is idempotent under re-registration of equal content: the
    same (operator bytes, precond spec) fingerprint returns the existing
    entry, preconditioner and programs included, under whichever names it
    was registered.
    """

    def __init__(self, scfg: ServiceConfig):
        self._scfg = scfg
        self._by_name: Dict[str, RegisteredOperator] = {}
        self._by_fp: Dict[str, RegisteredOperator] = {}

    def _make_session(self, op, precond: PrecondLike) -> LinearSolver:
        scfg = self._scfg
        cfg = SolverConfig(tol=scfg.tol, maxiter=scfg.maxiter,
                           trace_cap=scfg.trace_cap)
        if scfg.recovery is not None:
            # guarded serving: the programs step with the (11, m) health
            # reduction and carry typed per-column statuses
            from ..resilience.guard import guarded_config
            cfg = guarded_config(cfg, scfg.recovery)
        return make_solver("p-bicgsafe", op, precond=precond,
                           substrate=scfg.substrate, config=cfg,
                           device=scfg.device)

    def register(self, op, precond: PrecondLike = None,
                 name: Optional[str] = None) -> str:
        # fingerprint first, session only on a miss: re-registering known
        # content stays cheap (no throwaway preconditioner builds)
        try:
            fp = operator_fingerprint(op, precond)
        except TypeError:
            raise TypeError(
                "the solve service requires a content-addressable operator "
                f"object (got {type(op).__name__}); wrap the matvec in an "
                "operator class (Dense/CSR/ELL/Stencil7) to register it"
            ) from None
        entry = self._by_fp.get(fp)
        if entry is None:
            if name is None:                 # first free auto name
                i = len(self._by_fp)
                while f"op{i}" in self._by_name:
                    i += 1
                name = f"op{i}"
            elif name in self._by_name \
                    and self._by_name[name].fingerprint != fp:
                raise ValueError(
                    f"operator name {name!r} already registered with "
                    "different content")
            # the session only after the name check: a refused
            # registration must not take a session cache slot
            session = self._make_session(op, precond)
            entry = RegisteredOperator(name, op, precond, self._scfg, session)
            self._by_fp[fp] = entry
            self._by_name[name] = entry
        elif name is not None:
            existing = self._by_name.get(name)
            if existing is not None and existing.fingerprint != fp:
                raise ValueError(
                    f"operator name {name!r} already registered with "
                    "different content")
            self._by_name[name] = entry     # alias to the cached entry
        return entry.name if name is None else name

    def register_scenario(self, scenario,
                          name: Optional[str] = None) -> str:
        """Register a scenario's operator + preconditioner by name.

        ``scenario`` is a registered scenario name or a
        :class:`repro_torch.scenarios.Scenario`; the operator is built
        through its plugin on the service's device (cached per spec content
        and device, so two engines registering the same scenario share one
        session).  The engine serves its own open-loop p-BiCGSafe blocks
        under :class:`ServiceConfig`: a scenario contributes its operator,
        precond and name; its method/substrate/tol describe the offline
        sweep cell, not the serving configuration.
        """
        from ..scenarios import resolve_scenario
        sc = resolve_scenario(scenario)
        op = sc.problem(self._scfg.device)[0]
        return self.register(op, sc.precond, name or sc.name)

    def __getitem__(self, name: str) -> RegisteredOperator:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(
                f"unknown operator {name!r}; registered: "
                f"{sorted(self._by_name)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def entries(self):
        """Unique entries (aliases deduplicated), registration order."""
        return list(self._by_fp.values())

    def names(self):
        return sorted(self._by_name)
