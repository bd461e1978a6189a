"""Scenario vocabulary: frozen, composable, losslessly serializable
(PyTorch port of ``repro.scenarios.types``).

A :class:`Scenario` is ONE cell of the regression matrix the port must
hold (operator class x method x substrate x precond x guard/recovery x
batch shape x binding) written down as data.  Cells are hashable value
objects: two scenarios with equal content compare equal, and
``Scenario.bind()`` routes through :func:`repro_torch.api.make_solver`'s
content-keyed session cache, so binding the same scenario twice on one
device returns the SAME session (no new program, no preconditioner
rebuild).

Serialization is a contract: ``from_dict(to_dict(sc)) == sc`` exactly, so
scenario files given to the audit CLI (``python -m repro_torch.analysis
audit --scenarios FILE``) and artifacts that embed scenario specs
round-trip without drift.  The substrates are the port's: ``"torch"``
(plain PyTorch, the default) and ``"cuda"`` (the hand-written kernels).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

__all__ = ["ScenarioError", "OperatorSpec", "Scenario", "BINDINGS"]

#: binding kinds a scenario may request; "auto" resolves to "batched"
#: when batch > 1 else "single" (as repro_torch.analysis.trace names them)
BINDINGS = ("auto", "single", "batched", "open_loop", "mesh")

#: JSON-representable scalar types allowed as operator params: the spec
#: must survive a JSON round-trip unchanged
_SCALARS = (bool, int, float, str)


class ScenarioError(ValueError):
    """A scenario or operator-class registration/lookup problem, with a
    message meant for humans at the CLI (never a traceback)."""


@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """One operator-class invocation: plugin name + builder kwargs.

    ``params`` is a sorted tuple of (key, value) pairs so the spec is
    hashable and order-insensitive; :meth:`of` is the ergonomic
    constructor (``OperatorSpec.of("poisson3d", nx=8)``).
    """

    cls: str
    params: Tuple[Tuple[str, Any], ...] = ()

    @classmethod
    def of(cls_, cls: str, **params) -> "OperatorSpec":
        for k, v in params.items():
            if not isinstance(v, _SCALARS):
                raise ScenarioError(
                    f"operator param {k}={v!r} of class {cls!r} is not a "
                    "JSON scalar (bool/int/float/str); scenario specs "
                    "must round-trip through JSON")
        return cls_(cls, tuple(sorted(params.items())))

    @property
    def kwargs(self) -> Dict[str, Any]:
        return dict(self.params)

    def to_dict(self) -> dict:
        return {"cls": self.cls, "params": self.kwargs}

    @classmethod
    def from_dict(cls_, d: dict) -> "OperatorSpec":
        if not isinstance(d, dict) or "cls" not in d:
            raise ScenarioError(
                f"operator spec must be a dict with a 'cls' key; got {d!r}")
        unknown = set(d) - {"cls", "params"}
        if unknown:
            raise ScenarioError(
                f"unknown operator-spec keys {sorted(unknown)} "
                f"(expected 'cls' and optional 'params')")
        return cls_.of(d["cls"], **(d.get("params") or {}))

    def __str__(self):
        kw = ", ".join(f"{k}={v!r}" for k, v in self.params)
        return f"{self.cls}({kw})"


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One regression cell, declaratively.

    Fields mirror the knobs of :func:`repro_torch.api.make_solver` plus the
    run shape (``batch``, ``binding``) and sweep metadata (``tags``,
    ``quick``).  Construction is cheap and validation-free;
    :meth:`validate` (run at registration and before ``bind``) checks
    every name against the live registries and raises
    :class:`ScenarioError` with the valid choices spelled out.  The device
    is not a field: :meth:`bind` and :meth:`problem` take it (``None``:
    the card).
    """

    name: str
    operator: OperatorSpec
    method: str = "p-bicgsafe"
    substrate: str = "torch"
    precond: Optional[str] = None
    guard: bool = False
    recovery: bool = False
    tol: float = 1e-8
    maxiter: int = 2000
    batch: int = 1
    binding: str = "auto"
    trace: bool = False
    tags: Tuple[str, ...] = ()
    #: include in ``--quick`` sweeps / the quick contract audit
    quick: bool = True

    # -- resolution -------------------------------------------------------

    def resolved_binding(self) -> str:
        if self.binding != "auto":
            return self.binding
        return "batched" if self.batch > 1 else "single"

    def validate(self) -> "Scenario":
        """Check every name against the live registries (operator
        classes, solvers, substrates, preconditioners); raises
        :class:`ScenarioError` naming the valid choices."""
        from ..core import SOLVERS
        from ..core.substrate import SUBSTRATES
        from ..precond.base import PRECONDITIONERS
        from .registry import operator_class_names
        if not self.name or not isinstance(self.name, str):
            raise ScenarioError(f"scenario needs a non-empty name; "
                                f"got {self.name!r}")
        if self.operator.cls not in operator_class_names():
            raise ScenarioError(
                f"scenario {self.name!r} names unregistered operator "
                f"class {self.operator.cls!r}; registered classes: "
                f"{', '.join(operator_class_names())}")
        if self.method not in SOLVERS:
            raise ScenarioError(
                f"scenario {self.name!r} names unknown method "
                f"{self.method!r}; expected one of {sorted(SOLVERS)}")
        if self.substrate not in SUBSTRATES:
            raise ScenarioError(
                f"scenario {self.name!r} names unknown substrate "
                f"{self.substrate!r}; expected one of {sorted(SUBSTRATES)}")
        if self.precond is not None and self.precond not in PRECONDITIONERS:
            raise ScenarioError(
                f"scenario {self.name!r} names unknown precond "
                f"{self.precond!r}; expected one of "
                f"{sorted(PRECONDITIONERS)} or null")
        if self.binding not in BINDINGS:
            raise ScenarioError(
                f"scenario {self.name!r}: unknown binding "
                f"{self.binding!r}; expected one of {BINDINGS}")
        if self.batch < 1:
            raise ScenarioError(
                f"scenario {self.name!r}: batch must be >= 1")
        if self.resolved_binding() in ("batched", "open_loop") \
                and self.method != "p-bicgsafe":
            raise ScenarioError(
                f"scenario {self.name!r}: binding "
                f"{self.resolved_binding()!r} runs the batched "
                "p-BiCGSafe iteration only; bind method 'p-bicgsafe' "
                "or use binding 'single'")
        if (self.guard or self.recovery) and self.method != "p-bicgsafe":
            raise ScenarioError(
                f"scenario {self.name!r}: guard/recovery ride the "
                "batched p-BiCGSafe iteration only")
        return self

    # -- materialization --------------------------------------------------

    def config(self):
        """The bound :class:`repro_torch.core.SolverConfig` for this cell."""
        from ..core import SolverConfig
        return SolverConfig(tol=self.tol, maxiter=self.maxiter,
                            guard=self.guard)

    def problem(self, device=None):
        """Build (cached per spec and device) ``(op, b, x_true)`` via the
        operator plugin, on ``device`` (``None``: the card)."""
        from .registry import build_problem
        return build_problem(self.operator, device=device)

    def bind(self, device=None):
        """Materialize the session via :func:`repro_torch.api.make_solver`
        on ``device`` (``None``: the card).

        The built operator is cached per spec content and device, so
        repeat binds of the same scenario hand make_solver the SAME
        operator object and hit the session cache: no new program, no
        preconditioner rebuild.  ``recovery=True`` scenarios return a
        :class:`repro_torch.resilience.GuardedSolver` wrapper (the session
        underneath is still cached by content).
        """
        from ..api import make_solver
        self.validate()
        op, _, _ = self.problem(device)
        return make_solver(self.method, op, precond=self.precond,
                           substrate=self.substrate, config=self.config(),
                           device=device,
                           recovery=True if self.recovery else None)

    def contract_cell(self) -> dict:
        """This scenario as one :mod:`repro_torch.analysis` audit cell: the
        trace_binding coordinates plus the operator spec and the plugin's
        expected-outcome overrides."""
        from .registry import get_operator_class
        plugin = get_operator_class(self.operator.cls)
        return dict(method=self.method, binding=self.resolved_binding(),
                    substrate=self.substrate, guard=self.guard,
                    precond=self.precond, scenario=self.name,
                    operator_class=self.operator.cls,
                    operator_params=self.operator.kwargs,
                    expected=dict(plugin.contract_overrides))

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["operator"] = self.operator.to_dict()
        d["tags"] = list(self.tags)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        if not isinstance(d, dict):
            raise ScenarioError(f"scenario must be a dict; got {d!r}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ScenarioError(
                f"unknown scenario keys {sorted(unknown)}; expected a "
                f"subset of {sorted(known)}")
        missing = {"name", "operator"} - set(d)
        if missing:
            raise ScenarioError(
                f"scenario is missing required keys {sorted(missing)}")
        kw = dict(d)
        kw["operator"] = OperatorSpec.from_dict(d["operator"])
        kw["tags"] = tuple(d.get("tags") or ())
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise ScenarioError(f"scenario JSON does not parse: {e}") \
                from None
        return cls.from_dict(d)
