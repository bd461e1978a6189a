"""repro_torch.core — the paper's method on PyTorch: pipelined BiCGSafe,
and the methods the paper compares it with.

FRONT DOOR: :mod:`repro_torch.api` —
``repro_torch.make_solver(method, op, substrate=...).solve(b)``.

* Solvers (``(matvec, b, x0=None, *, config, r0_star, substrate,
  precond, stats)``), the JAX package's seven, with their reductions per
  iteration:
  - :func:`bicgstab_solve`        BiCGStab            (Alg. 2.1, 2 syncs)
  - :func:`pbicgstab_solve`       pipelined BiCGStab  (Cools-Vanroose, 2 overlapped)
  - :func:`gpbicg_solve`          GPBi-CG             (Alg. 2.2, 3 syncs)
  - :func:`cgs_solve`             CGS                 (Sonneveld, 2 syncs)
  - :func:`ssbicgsafe2_solve`     ssBiCGSafe2         (Alg. 2.3, 1 sync)
  - :func:`pbicgsafe_solve`       p-BiCGSafe          (Alg. 3.1, 1 overlapped sync)
  - :func:`pbicgsafe_rr_solve`    p-BiCGSafe-rr       (Alg. 4.1, 1 overlapped sync)
  - :func:`solve_batched`         p-BiCGSafe on (n, m) right-hand sides, one
    (9, m) reduction per iteration; open-loop pieces :func:`init_state`,
    :func:`step_chunk`, :func:`splice_columns`, :func:`result_from_state`;
    ``SolverConfig(guard=True)`` widens its phase to (11, m) health rows
    (driven by :mod:`repro_torch.resilience`)
* Operators: Dense/CSR/ELL/Stencil7.
* Problem generators: :mod:`repro_torch.core.matrices`.
* Compute substrates: ``substrate="torch"|"cuda"``
  (:mod:`repro_torch.core.substrate`).
* Programs: :mod:`repro_torch.core.program`, a chunk of steps captured
  as one CUDA graph (the counterpart of ``jax.jit``).
"""
from .bicgstab import BICGSTAB, bicgstab_solve
from .cgs import CGS, cgs_solve
from .gpbicg import GPBICG, gpbicg_solve
from .linear_operator import (CSROperator, DenseOperator, ELLOperator,
                              Stencil7Operator, as_matvec)
from .multirhs import (GUARD_FIELDS, init_state, result_from_state,
                       solve_batched, splice_columns, step_chunk)
from .pipelined_bicgsafe import (PBICGSAFE, PBICGSAFE_RR,
                                 pbicgsafe_rr_solve, pbicgsafe_solve)
from .pipelined_bicgstab import PBICGSTAB, pbicgstab_solve
from .ssbicgsafe import SSBICGSAFE2, ssbicgsafe2_solve
from .substrate import (SUBSTRATES, CudaSubstrate, Substrate, TorchSubstrate,
                        get_substrate)
from .types import SolveResult, SolveStatus, SolverConfig

SOLVERS = {
    "bicgstab": bicgstab_solve,
    "p-bicgstab": pbicgstab_solve,
    "gpbicg": gpbicg_solve,
    "cgs": cgs_solve,
    "ssbicgsafe2": ssbicgsafe2_solve,
    "p-bicgsafe": pbicgsafe_solve,
    "p-bicgsafe-rr": pbicgsafe_rr_solve,
}

#: each of ``SOLVERS`` as the chunked loop runs it (set-up, body, result):
#: what a session's programs are built from
CHUNKED = {
    "bicgstab": BICGSTAB,
    "p-bicgstab": PBICGSTAB,
    "gpbicg": GPBICG,
    "cgs": CGS,
    "ssbicgsafe2": SSBICGSAFE2,
    "p-bicgsafe": PBICGSAFE,
    "p-bicgsafe-rr": PBICGSAFE_RR,
}

__all__ = [
    "SolveResult", "SolveStatus", "SolverConfig",
    "CSROperator", "DenseOperator", "ELLOperator", "Stencil7Operator",
    "as_matvec",
    "Substrate", "TorchSubstrate", "CudaSubstrate", "SUBSTRATES",
    "get_substrate",
    "bicgstab_solve", "pbicgstab_solve", "gpbicg_solve", "cgs_solve",
    "ssbicgsafe2_solve", "pbicgsafe_solve", "pbicgsafe_rr_solve", "SOLVERS",
    "CHUNKED",
    "solve_batched", "init_state", "step_chunk", "splice_columns",
    "result_from_state", "GUARD_FIELDS",
]
