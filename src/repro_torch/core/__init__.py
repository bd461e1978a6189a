"""repro_torch.core — the paper's method on PyTorch: pipelined BiCGSafe.

FRONT DOOR: :mod:`repro_torch.api` —
``repro_torch.make_solver(method, op, substrate=...).solve(b)``.

* Solvers (``(matvec, b, x0=None, *, config, r0_star, substrate)``):
  - :func:`pbicgsafe_solve`       p-BiCGSafe          (Alg. 3.1, 1 overlapped sync)
  - :func:`pbicgsafe_rr_solve`    p-BiCGSafe-rr       (Alg. 4.1)
  - :func:`solve_batched`         p-BiCGSafe on (n, m) right-hand sides, one
    (9, m) reduction per iteration; open-loop pieces :func:`init_state`,
    :func:`step_chunk`, :func:`splice_columns`, :func:`result_from_state`
* Operators: Dense/CSR/ELL/Stencil7.
* Problem generators: :mod:`repro_torch.core.matrices`.
* Compute substrates: ``substrate="torch"|"cuda"``
  (:mod:`repro_torch.core.substrate`).
"""
from .linear_operator import (CSROperator, DenseOperator, ELLOperator,
                              Stencil7Operator, as_matvec)
from .multirhs import (init_state, result_from_state, solve_batched,
                       splice_columns, step_chunk)
from .pipelined_bicgsafe import pbicgsafe_rr_solve, pbicgsafe_solve
from .substrate import (SUBSTRATES, CudaSubstrate, Substrate, TorchSubstrate,
                        get_substrate)
from .types import SolveResult, SolveStatus, SolverConfig

SOLVERS = {
    "p-bicgsafe": pbicgsafe_solve,
    "p-bicgsafe-rr": pbicgsafe_rr_solve,
}

__all__ = [
    "SolveResult", "SolveStatus", "SolverConfig",
    "CSROperator", "DenseOperator", "ELLOperator", "Stencil7Operator",
    "as_matvec",
    "Substrate", "TorchSubstrate", "CudaSubstrate", "SUBSTRATES",
    "get_substrate",
    "pbicgsafe_solve", "pbicgsafe_rr_solve", "SOLVERS",
    "solve_batched", "init_state", "step_chunk", "splice_columns",
    "result_from_state",
]
