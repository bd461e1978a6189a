"""The registered seed scenarios: the matrix subset the port regresses
(PyTorch port of ``repro.scenarios.seeds``).

The same 17 scenarios as the JAX package, under the same names, in the
same order and with the same operator specs, so each sweep cell lines up
by name with the JAX package's ``experiments/scenario_sweep.json``.  The
substrates are the port's: the JAX ``"jnp"`` is ``"torch"`` and
``"pallas"`` is ``"cuda"`` (the names keep their ``-pallas`` suffix).  The
quick flag marks the CI-sized subset (``sweep --quick`` / the quick
contract audit); the full set adds the larger problems.

Naming: ``<operator>-<distinguishing axis>``.
"""
from __future__ import annotations

from .registry import register_scenario
from .types import OperatorSpec, Scenario

_CONVDIFF8 = OperatorSpec.of("convection_diffusion", nx=8, peclet=1.0)

# -- the paper's method over the seed operator classes ---------------------

register_scenario(Scenario(
    "convdiff-baseline", _CONVDIFF8, tags=("core", "convergence")))

register_scenario(Scenario(
    "convdiff-multirhs-pallas", _CONVDIFF8, substrate="cuda", batch=4,
    tags=("core", "kernels", "multirhs")))

register_scenario(Scenario(
    "convdiff-guarded", _CONVDIFF8, guard=True, batch=3,
    tags=("resilience",)))

register_scenario(Scenario(
    "convdiff-recovery", _CONVDIFF8, recovery=True,
    tags=("resilience",)))

register_scenario(Scenario(
    "convdiff-openloop", _CONVDIFF8, binding="open_loop", batch=3,
    tags=("service",)))

register_scenario(Scenario(
    "poisson-jacobi", OperatorSpec.of("poisson3d", nx=8),
    precond="jacobi", tags=("core", "precond")))

register_scenario(Scenario(
    "aniso-block-jacobi", OperatorSpec.of("anisotropic3d", nx=8, eps=1e-2),
    precond="block_jacobi", tags=("precond",)))

register_scenario(Scenario(
    "hard-block-jacobi", OperatorSpec.of("hard_nonsym", n=300),
    precond="block_jacobi", maxiter=3000, tags=("precond", "hard")))

register_scenario(Scenario(
    "random-csr-rr", OperatorSpec.of("random_nonsym", n=2000,
                                     nnz_per_row=8, seed=5),
    method="p-bicgsafe-rr", tags=("core",)))

# -- negative controls: the baselines the contract audit must FAIL --------

register_scenario(Scenario(
    "ssbicgsafe2-baseline", _CONVDIFF8, method="ssbicgsafe2",
    tags=("baseline",)))

register_scenario(Scenario(
    "bicgstab-baseline", _CONVDIFF8, method="bicgstab",
    tags=("baseline",)))

# -- the plugin-registered operator class (no core edits) ------------------

register_scenario(Scenario(
    "helmholtz-shifted", OperatorSpec.of("helmholtz_shifted", nx=8),
    maxiter=4000, tags=("helmholtz", "plugin")))

register_scenario(Scenario(
    "helmholtz-jacobi", OperatorSpec.of("helmholtz_shifted", nx=8),
    precond="jacobi", maxiter=4000, tags=("helmholtz", "plugin",
                                          "precond")))

register_scenario(Scenario(
    "helmholtz-multirhs-pallas",
    OperatorSpec.of("helmholtz_shifted", nx=6), substrate="cuda",
    batch=2, maxiter=4000, tags=("helmholtz", "plugin", "kernels")))

# -- full-sweep-only cells (committed artifact; not --quick) ---------------

register_scenario(Scenario(
    "poisson-mesh", OperatorSpec.of("poisson3d", nx=8, ny=6, nz=6),
    binding="mesh", quick=False, tags=("distributed",)))

register_scenario(Scenario(
    "convdiff-16-multirhs", OperatorSpec.of("convection_diffusion",
                                            nx=16, peclet=1.0),
    batch=8, quick=False, tags=("multirhs",)))

register_scenario(Scenario(
    "random-20k", OperatorSpec.of("random_nonsym", n=20_000,
                                  nnz_per_row=9, seed=5,
                                  diag_dominance=1.02),
    maxiter=5000, quick=False, tags=("convergence",)))
