"""Snapshot of the public ``repro_torch`` namespace against the JAX
package's (``tests/test_api_surface.py``).

The port's front door exports every name of the JAX ``PUBLIC_API`` (each
one ported) plus the port's own additions, listed one by one below; a name
that drifts in or out of ``repro_torch.__all__`` fails here (ROADMAP C19),
and the fix is an intentional edit of both the package ``__all__`` and
this snapshot.
"""
import pytest

pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  caps torch's threads

import repro_torch  # noqa: E402
from test_api_surface import PUBLIC_API  # noqa: E402

#: the port's own public names, beyond the JAX package's: its service and
#: session-cache entry points, the open-loop and batched free functions,
#: the numpy converters, the precond package and the guard's field list
PORT_ONLY = [
    "GUARD_FIELDS",
    "ServiceConfig",
    "SolveEngine",
    "clear_session_cache",
    "init_state",
    "lm_params_from_numpy",
    "operator_from_numpy",
    "precond",
    "preconditioner_from_numpy",
    "result_from_state",
    "session_cache_info",
    "solve_batched",
    "splice_columns",
    "step_chunk",
]


def test_all_is_the_jax_public_api_plus_the_port_names():
    assert not set(PORT_ONLY) & set(PUBLIC_API)
    assert sorted(repro_torch.__all__) == sorted(PUBLIC_API + PORT_ONLY), (
        "public repro_torch namespace drifted; if intentional, update BOTH "
        "repro_torch/__init__.__all__ and tests/test_torch_api_surface.py")


@pytest.mark.parametrize("name", PUBLIC_API + PORT_ONLY)
def test_export_exists(name):
    assert hasattr(repro_torch, name), f"declared export {name!r} missing"


def test_ported_names_are_the_port_objects():
    """The C19 names resolve to the port's own classes and functions."""
    from repro_torch.observe.trace import ConvergenceTrace
    from repro_torch.precond.base import Preconditioner
    from repro_torch.scenarios import registry, types
    assert repro_torch.ConvergenceTrace is ConvergenceTrace
    assert repro_torch.Preconditioner is Preconditioner
    assert repro_torch.Scenario is types.Scenario
    assert repro_torch.OperatorSpec is types.OperatorSpec
    assert repro_torch.register_scenario is registry.register_scenario
    assert repro_torch.register_operator_class \
        is registry.register_operator_class


def test_precond_reexports_operator_fingerprint():
    """As ``repro.precond`` does (``src/repro/precond/__init__.py``)."""
    assert repro_torch.precond.operator_fingerprint \
        is repro_torch.operator_fingerprint
    assert "operator_fingerprint" in repro_torch.precond.__all__


def test_solver_registry_matches_methods():
    assert sorted(repro_torch.SOLVERS) == [
        "bicgstab", "cgs", "gpbicg", "p-bicgsafe", "p-bicgsafe-rr",
        "p-bicgstab", "ssbicgsafe2"]
