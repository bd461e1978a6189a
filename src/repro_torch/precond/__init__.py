"""repro_torch.precond — the preconditioning subsystem (PyTorch port of
:mod:`repro.precond`).

Fixed linear M^{-1} operators threaded through every solver entry point
of the port via ``precond=`` (left preconditioning: the solvers run on
M^{-1} A with M^{-1} b, so ``relres``/``tol`` measure the preconditioned
residual).  Each takes ``(n,)`` vectors and ``(n, m)`` column blocks:

* :func:`jacobi`        — diag(A)^{-1}; one elementwise multiply.
* :func:`block_jacobi`  — pre-inverted dense diagonal blocks, applied by
  the hand-written CUDA kernels on ``substrate="cuda"``
  (:mod:`repro_torch.kernels.precond_apply`).
* :func:`neumann`       — degree-d truncated Neumann polynomial; its
  matvecs run on the substrate's SpMV kernels.
* :func:`ssor`          — truncated-Neumann SSOR for Stencil7 operators.

``precond=`` also takes these names as strings when the solver is handed
an operator object to build from.
"""
from .base import (PRECONDITIONERS, Preconditioner, PrecondLike,
                   preconditioned_matvec, preconditioned_system,
                   resolve_precond, validate_precond_spec,
                   wrap_block_preconditioned)
from .block_jacobi import BlockJacobiPreconditioner, block_jacobi
from .jacobi import JacobiPreconditioner, jacobi
from .polynomial import NeumannPreconditioner, neumann
from .ssor import SSORPreconditioner, ssor

__all__ = [
    "Preconditioner", "PrecondLike", "PRECONDITIONERS",
    "resolve_precond", "validate_precond_spec", "preconditioned_system",
    "wrap_block_preconditioned", "preconditioned_matvec",
    "JacobiPreconditioner", "jacobi",
    "BlockJacobiPreconditioner", "block_jacobi",
    "NeumannPreconditioner", "neumann",
    "SSORPreconditioner", "ssor",
    "operator_fingerprint",
]

# last: repro_torch.api imports this package's modules while it loads
from ..api import operator_fingerprint  # noqa: E402
