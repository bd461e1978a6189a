"""The global scenario + operator-class registries (PyTorch port of
``repro.scenarios.registry``).

Two tables, both content-aware, with the name conflict rule of
``service/registry.py``:

* :data:`OPERATOR_CLASSES`: name -> :class:`OperatorPlugin`.  A plugin is
  the ONE definition of a problem family: the builder that materializes
  ``(op, b, x_true)`` on a device, the verification oracle the sweep runs
  on solutions, and the expected-outcome deltas the contract audit merges
  over :func:`repro_torch.analysis.audit.expected_outcomes`.
* :data:`SCENARIOS`: name -> :class:`~.types.Scenario`.  Registration
  validates every name the scenario references; re-registering EQUAL
  content is idempotent (returns the existing entry), a name collision
  with different content raises.

Built problems are memoized per (spec content, device) (a bounded LRU),
so repeat ``Scenario.bind()`` calls hand :func:`repro_torch.api
.make_solver` the same operator object and hit the session cache.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..core.types import resolve_device
from .types import OperatorSpec, Scenario, ScenarioError

__all__ = [
    "OperatorPlugin", "register_operator_class", "register_scenario",
    "get_operator_class", "get_scenario", "resolve_scenario",
    "operator_class_names", "scenario_names", "scenarios",
    "build_problem", "default_oracle",
]


def _host(v) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def default_oracle(problem, B, X, tol: float) -> dict:
    """The stock verification oracle: per-column true residual.

    ``B``/``X`` are (n, m) numpy arrays (the sweep normalizes single-RHS
    results to one column).  A solution verifies when every column's TRUE
    relative residual, recomputed through the operator on its device (not
    the solver's recurrence), lands within 50x the requested tolerance
    (pipelined recurrences drift near tol; the order-of-magnitude guard the
    benchmarks use).  The norms are taken in numpy on host copies.
    """
    op, _, x_true = problem
    dev = getattr(op, "device", None)
    AX = np.stack([_host(op.matvec(torch.as_tensor(X[:, j], device=dev)))
                   for j in range(X.shape[1])], axis=1)
    bnorm = np.linalg.norm(B, axis=0)
    relres = np.linalg.norm(B - AX, axis=0) / np.where(bnorm == 0, 1, bnorm)
    detail = {"relres_true": float(relres.max())}
    if x_true is not None and B.shape[1] >= 1:
        # column 0 of every sweep block is the unit-solution rhs
        detail["x_err"] = float(np.abs(X[:, 0] - _host(x_true)).max())
    return {"ok": bool(relres.max() <= 50 * tol), **detail}


@dataclasses.dataclass(frozen=True)
class OperatorPlugin:
    """One operator class, registered from the outside.

    ``build(device=..., **params)`` returns ``(op, b, x_true)`` on that
    device with the unit-solution protocol (``x_true`` may be None for
    oracle-only verification).  ``oracle(problem, B, X, tol)`` judges a
    sweep solution (default: :func:`default_oracle`'s true-residual
    check).  ``contract_overrides`` maps contract name -> expected status
    ("ok"/"violation"/"skipped"), merged over the paper's per-method
    expected matrix for every audit cell that uses this class: how a
    plugin declares that its operators legitimately deviate.
    ``mesh_capable`` gates ``binding="mesh"`` scenarios (the sharded
    driver needs the row-sharded stencil halo format).
    """

    name: str
    build: Callable
    oracle: Callable = default_oracle
    contract_overrides: Tuple[Tuple[str, str], ...] = ()
    mesh_capable: bool = False
    description: str = ""


OPERATOR_CLASSES: Dict[str, OperatorPlugin] = {}
SCENARIOS: "OrderedDict[str, Scenario]" = OrderedDict()

#: built-problem memo: (OperatorSpec, device) -> (op, b, x_true).  The
#: same spec built on the CPU and on the card is two problems, so the
#: device is part of the key.  Bounded: a sweep over many one-off specs
#: must not pin every operator's tensors.
_PROBLEMS: "OrderedDict[tuple, tuple]" = OrderedDict()
_PROBLEMS_MAX = 32


def register_operator_class(
        name: str, build: Optional[Callable] = None, *,
        oracle: Optional[Callable] = None,
        contract_overrides: Optional[Mapping[str, str]] = None,
        mesh_capable: bool = False,
        description: str = "") -> Union[OperatorPlugin, Callable]:
    """Register an operator-class plugin; usable as a decorator::

        @register_operator_class("helmholtz_shifted", oracle=my_oracle)
        def build(nx=8, ..., device=None):
            return op, b, x_true

    Re-registering the same name with the same builder is idempotent; a
    different builder under a taken name raises (the ``service/registry.py``
    conflict rule).
    """
    def _register(build_fn: Callable) -> OperatorPlugin:
        plugin = OperatorPlugin(
            name=name, build=build_fn,
            oracle=oracle if oracle is not None else default_oracle,
            contract_overrides=tuple(sorted(
                (contract_overrides or {}).items())),
            mesh_capable=mesh_capable,
            description=description or (build_fn.__doc__ or "")
            .strip().split("\n")[0])
        existing = OPERATOR_CLASSES.get(name)
        if existing is not None:
            if existing.build is build_fn \
                    and existing.contract_overrides \
                    == plugin.contract_overrides:
                return existing
            raise ScenarioError(
                f"operator class {name!r} already registered with "
                "different content")
        OPERATOR_CLASSES[name] = plugin
        return plugin

    if build is not None:
        return _register(build)
    return _register                         # decorator form


def get_operator_class(name: str) -> OperatorPlugin:
    try:
        return OPERATOR_CLASSES[name]
    except KeyError:
        raise ScenarioError(
            f"unregistered operator class {name!r}; registered classes: "
            f"{', '.join(operator_class_names()) or '(none)'}") from None


def operator_class_names() -> List[str]:
    return sorted(OPERATOR_CLASSES)


def build_problem(spec: Union[OperatorSpec, str], *, device=None,
                  **params):
    """Materialize ``(op, b, x_true)`` for one operator spec on ``device``
    (``None``: the card), memoized per spec content and device.  Accepts
    an :class:`OperatorSpec` or ``build_problem("poisson3d", nx=8)``."""
    if isinstance(spec, str):
        spec = OperatorSpec.of(spec, **params)
    elif params:
        raise TypeError("pass params inside the OperatorSpec OR as "
                        "kwargs with a class name, not both")
    plugin = get_operator_class(spec.cls)
    dev = resolve_device(device)
    key = (spec, dev)
    hit = _PROBLEMS.get(key)
    if hit is not None:
        _PROBLEMS.move_to_end(key)
        return hit
    try:
        prob = plugin.build(device=dev, **spec.kwargs)
    except TypeError as e:
        raise ScenarioError(
            f"operator class {spec.cls!r} rejected params "
            f"{spec.kwargs!r}: {e}") from None
    if not (isinstance(prob, tuple) and len(prob) == 3):
        raise ScenarioError(
            f"operator class {spec.cls!r} builder must return "
            f"(op, b, x_true); got {type(prob).__name__}")
    _PROBLEMS[key] = prob
    while len(_PROBLEMS) > _PROBLEMS_MAX:
        _PROBLEMS.popitem(last=False)
    return prob


def register_scenario(sc: Union[Scenario, Callable]) -> Scenario:
    """Register one scenario (validating every referenced name).

    Usable directly (``register_scenario(Scenario(...))``) or as a
    decorator on a zero-arg factory::

        @register_scenario
        def _poisson():
            return Scenario("poisson-jacobi", OperatorSpec.of(...), ...)

    Equal-content re-registration is idempotent; a taken name with
    different content raises :class:`ScenarioError`.
    """
    if callable(sc) and not isinstance(sc, Scenario):
        sc = sc()
    if not isinstance(sc, Scenario):
        raise ScenarioError(
            f"register_scenario expects a Scenario (or a factory "
            f"returning one); got {type(sc).__name__}")
    sc.validate()
    if not get_operator_class(sc.operator.cls).mesh_capable \
            and sc.resolved_binding() == "mesh":
        raise ScenarioError(
            f"scenario {sc.name!r}: operator class {sc.operator.cls!r} "
            "is not mesh-capable (the sharded driver needs the "
            "row-sharded stencil halo format)")
    existing = SCENARIOS.get(sc.name)
    if existing is not None:
        if existing == sc:
            return existing
        raise ScenarioError(
            f"scenario name {sc.name!r} already registered with "
            "different content")
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ScenarioError(
            f"unknown scenario {name!r}; registered: "
            f"{', '.join(SCENARIOS) or '(none)'}") from None


def resolve_scenario(sc: Union[str, Scenario]) -> Scenario:
    """Name -> registered scenario; a Scenario instance passes through
    (validated), so ad-hoc unregistered scenarios work everywhere a name
    does."""
    if isinstance(sc, str):
        return get_scenario(sc)
    if isinstance(sc, Scenario):
        return sc.validate()
    raise ScenarioError(
        f"expected a scenario name or Scenario; got {type(sc).__name__}")


def scenarios(quick: Optional[bool] = None,
              tags: Optional[Tuple[str, ...]] = None) -> List[Scenario]:
    """Registered scenarios in registration order, optionally filtered to
    quick cells and/or to those carrying any of ``tags``."""
    out = list(SCENARIOS.values())
    if quick:
        out = [s for s in out if s.quick]
    if tags:
        want = set(tags)
        out = [s for s in out if want & set(s.tags)]
    return out


def scenario_names() -> List[str]:
    return list(SCENARIOS)
