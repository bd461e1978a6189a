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

This package imports ``torch``, ``numpy`` and the standard library only —
nothing of the JAX package :mod:`repro`, which stays its reference.
"""
from .api import LinearSolver, make_solver, solve
from .convert import operator_from_numpy
from .core import (SOLVERS, SUBSTRATES, CSROperator, DenseOperator,
                   ELLOperator, SolveResult, SolverConfig, SolveStatus,
                   Stencil7Operator, get_substrate, init_state,
                   result_from_state, solve_batched, splice_columns,
                   step_chunk)

__all__ = [
    "LinearSolver", "make_solver", "solve", "operator_from_numpy",
    "SOLVERS", "SUBSTRATES", "get_substrate",
    "SolveResult", "SolveStatus", "SolverConfig",
    "CSROperator", "DenseOperator", "ELLOperator", "Stencil7Operator",
    "solve_batched", "init_state", "step_chunk", "splice_columns",
    "result_from_state",
]
