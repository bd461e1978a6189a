"""Jacobi (diagonal) preconditioner: M^{-1} = diag(A)^{-1} (PyTorch port of
``repro.precond.jacobi``).

The cheapest preconditioner and the one that matters most on badly
row-scaled systems (``hard_nonsym``).  The apply is one elementwise
multiply, plain PyTorch on either substrate: the JAX package has no kernel
for it either.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import Preconditioner


@dataclasses.dataclass(frozen=True, repr=False)
class JacobiPreconditioner(Preconditioner):
    """Left Jacobi preconditioner M^{-1} = diag(A)^{-1}."""

    inv_diag: torch.Tensor

    name = "jacobi"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        d = self.inv_diag if x.dim() == 1 else self.inv_diag[:, None]
        return d * x

    @staticmethod
    def from_operator(op) -> "JacobiPreconditioner":
        """Build from ``op.diagonal()``.  A zero diagonal entry gets 1 (the
        apply leaves that row alone); the substitute and the reciprocal are
        formed in the diagonal's own dtype."""
        d = op.diagonal()
        one = torch.ones((), dtype=d.dtype, device=d.device)
        return JacobiPreconditioner(torch.where(d != 0, one / d, one))


def jacobi(op) -> JacobiPreconditioner:
    """Factory: Jacobi preconditioner from any operator with ``diagonal()``."""
    return JacobiPreconditioner.from_operator(op)
