"""repro_torch — the PyTorch / CUDA port of :mod:`repro`.

p-BiCGSafe and p-BiCGSafe-rr (Huynh & Suito 2021, Alg. 3.1 / 4.1) on one
right-hand side, and p-BiCGSafe on an (n, m) block of them, with the fused
9-dot phase, the fused update phase and the ELL SpMV as hand-written CUDA
kernels for Hopper (``substrate="cuda"``), each in a single-RHS and a
batched form:

    import torch
    import repro_torch
    from repro_torch.core import matrices

    op, b, _ = matrices.convection_diffusion(64)          # on the card
    solver = repro_torch.make_solver("p-bicgsafe", matrices.stencil_to_ell(op),
                                     substrate="cuda")
    res = solver.solve(b)
    many = solver.solve_many(torch.stack([b, 2 * b], dim=1))   # (n, 2)

``SOLVERS`` holds the JAX package's seven methods: beside p-BiCGSafe and
-rr, the ones the paper compares them with, ssBiCGSafe2 (its one 9-dot
phase on the same kernel), p-BiCGStab, BiCGStab, GPBi-CG and CGS, each
through ``make_solver(method, op)``.

A session bound to a :class:`Stencil7Operator` solves on a
``torch.distributed`` mesh too, every rank holding an x-slab
(:mod:`repro_torch.core.distributed`: halo exchange, one asynchronous
all-reduce per reduction phase, started before the matvec it hides
behind): ``make_solver(method, stencil).on_mesh(mesh).solve(b_grid)``.

With ``recovery=`` (:mod:`repro_torch.resilience`) the batched iteration is
guarded: an (11, m) reduction with health rows, typed statuses and a
chunked recovery driver.  BiCGStab (plain PyTorch) is its method fallback.
With ``precond=`` (:mod:`repro_torch.precond`: ``"jacobi"``,
``"block_jacobi"``, ``"neumann"``, ``"ssor"``) every solve runs on the
left-preconditioned system; block-Jacobi's apply is a CUDA kernel too.

The LM stack's dense family serves on the card too (:mod:`repro_torch
.models`, :mod:`repro_torch.serve`, :mod:`repro_torch.configs`), its prefill
through a hand-written CUDA flash-attention kernel under
``cfg.use_flash_kernel``:

    from repro_torch.configs import get_config
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    eng = ServingEngine(get_config("qwen3-8b").replace(use_flash_kernel=True),
                        ServeConfig(max_batch=4, max_len=1056))

The regression matrix (operator class x method x substrate x precond x
guard x batch) is declarative data (:mod:`repro_torch.scenarios`): a
registered :class:`Scenario` is a cached session
(``make_solver(scenario="poisson-jacobi")``), a contract-audit row and a
``python -m repro_torch.scenarios sweep`` cell.

This package imports ``torch``, ``numpy`` and the standard library only —
nothing of the JAX package :mod:`repro`, which stays its reference.
"""
from . import precond
from .api import (DistributedSolver, LinearSolver, clear_session_cache,
                  make_solver, operator_fingerprint, session_cache_info,
                  solve)
from .convert import (lm_params_from_numpy, operator_from_numpy,
                      preconditioner_from_numpy)
from .core import (GUARD_FIELDS, SOLVERS, SUBSTRATES, CSROperator,
                   DenseOperator, ELLOperator, SolveResult, SolverConfig,
                   SolveStatus, Stencil7Operator, get_substrate, init_state,
                   result_from_state, solve_batched, splice_columns,
                   step_chunk)
from .observe import ConvergenceTrace
from .precond import Preconditioner
from .resilience import GuardedSolver, RecoveryPolicy
from .scenarios import (OperatorSpec, Scenario, register_operator_class,
                        register_scenario)
from .service import ServiceConfig, SolveEngine

__all__ = [
    "LinearSolver", "DistributedSolver", "make_solver", "solve",
    "operator_fingerprint",
    "clear_session_cache", "session_cache_info", "operator_from_numpy",
    "lm_params_from_numpy",
    "preconditioner_from_numpy", "precond",
    "SOLVERS", "SUBSTRATES", "get_substrate",
    "SolveResult", "SolveStatus", "SolverConfig",
    "CSROperator", "DenseOperator", "ELLOperator", "Stencil7Operator",
    "solve_batched", "init_state", "step_chunk", "splice_columns",
    "result_from_state", "GUARD_FIELDS", "GuardedSolver", "RecoveryPolicy",
    "ServiceConfig", "SolveEngine", "Preconditioner", "ConvergenceTrace",
    # the scenario registry (repro_torch.scenarios; make_solver(scenario=))
    "Scenario", "OperatorSpec", "register_scenario",
    "register_operator_class",
]
