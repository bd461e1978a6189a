"""repro_torch.scenarios — the declarative scenario registry + matrix sweep
(PyTorch port of :mod:`repro.scenarios`).

The regression surface of the port is a matrix: operator class x method x
substrate x precond x guard/recovery x batch x binding.  This package
writes the cells down as data:

    from repro_torch.scenarios import (OperatorSpec, Scenario,
                                       register_scenario)

    register_scenario(Scenario(
        "poisson-jacobi", OperatorSpec.of("poisson3d", nx=8),
        precond="jacobi"))

    solver = repro_torch.make_solver(scenario="poisson-jacobi")  # the card
    x = solver.solve(b)

One registration buys three things:

* a session: ``Scenario.bind(device)`` / ``make_solver(scenario=...,
  device=...)`` materializes the cell through the content-keyed session
  cache (a repeat bind returns the same session);
* a contract row: ``python -m repro_torch.analysis audit`` derives its cell
  list from this registry, so every scenario is held to the paper's
  communication invariants (plugins may declare expected-outcome deltas);
* a sweep cell: ``python -m repro_torch.scenarios sweep`` runs the subset
  and writes ONE consolidated ``experiments/torch_scenario_sweep.json``.

Operator classes are **plugins** (builder + verification oracle + expected
contract outcomes): :mod:`~repro_torch.scenarios.builtin` registers the
seed generators, and :mod:`~repro_torch.scenarios.helmholtz` registers a
complex-shifted Helmholtz class entirely from the outside.  The seed
scenarios (:mod:`~repro_torch.scenarios.seeds`) are the JAX package's 17,
by name, with its ``"jnp"`` substrate as ``"torch"`` and ``"pallas"`` as
``"cuda"``.
"""
from . import builtin as _builtin          # registers the seed classes
from . import helmholtz as _helmholtz      # the plugin-proof class
from . import seeds as _seeds              # registers the seed scenarios
from .helmholtz import HelmholtzShiftedOperator
from .registry import (OPERATOR_CLASSES, SCENARIOS, OperatorPlugin,
                       build_problem, default_oracle, get_operator_class,
                       get_scenario, operator_class_names,
                       register_operator_class, register_scenario,
                       resolve_scenario, scenario_names, scenarios)
from .types import BINDINGS, OperatorSpec, Scenario, ScenarioError

__all__ = [
    "Scenario", "OperatorSpec", "ScenarioError", "BINDINGS",
    "OperatorPlugin", "HelmholtzShiftedOperator",
    "register_scenario", "register_operator_class",
    "get_scenario", "get_operator_class", "resolve_scenario",
    "scenarios", "scenario_names", "operator_class_names",
    "build_problem", "default_oracle",
    "SCENARIOS", "OPERATOR_CLASSES",
    "contract_cells", "run_sweep",
]

del _builtin, _helmholtz, _seeds


def contract_cells(quick: bool = False):
    """Audit cells (dense matrix + per-scenario rows); see
    :mod:`repro_torch.scenarios.cells`."""
    from .cells import contract_cells as _cc
    return _cc(quick=quick)


def run_sweep(quick: bool = False, **kw):
    """Run the matrix sweep; see :mod:`repro_torch.scenarios.sweep` (lazy:
    importing the registry must not pull the runner and analysis stack)."""
    from .sweep import run_sweep as _rs
    return _rs(quick=quick, **kw)
