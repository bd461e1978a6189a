"""Neumann / polynomial preconditioner: M^{-1} = p_d(A) (PyTorch port of
``repro.precond.polynomial``).

Truncated Neumann series of the Jacobi-split inverse: with D = diag(A)
and G = I - omega D^{-1} A,

    M^{-1} x = (I + G + G^2 + ... + G^d) * omega D^{-1} x

which converges to A^{-1} as d grows whenever rho(G) < 1.  The apply is
d operator applications plus diagonal scalings, no inner product, so the
bound apply runs its matvecs through the substrate: on ``"cuda"`` an ELL
operator's series runs on the SpMV kernels (``spmv_ell`` for ``(n,)``,
``spmv_ell_batched`` for ``(n, m)``), d launches per apply.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import Preconditioner
from .jacobi import JacobiPreconditioner


@dataclasses.dataclass(frozen=True, repr=False)
class NeumannPreconditioner(Preconditioner):
    """Degree-``degree`` truncated Neumann series of ``op``'s inverse.

    Holds the operator itself, so the bound apply can route the series'
    matvecs through the substrate."""

    op: object
    inv_diag: torch.Tensor
    degree: int = 2
    omega: float = 1.0

    name = "neumann"

    def _apply_with(self, mv, x: torch.Tensor) -> torch.Tensor:
        d = self.inv_diag if x.dim() == 1 else self.inv_diag[:, None]
        z = self.omega * d * x
        y = z
        v = z
        for _ in range(self.degree):
            v = v - self.omega * d * mv(v)      # v <- G v
            y = y + v
        return y

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        from ..core.linear_operator import as_block_matvec, as_matvec
        mv = as_matvec(self.op) if x.dim() == 1 else as_block_matvec(self.op)
        return self._apply_with(mv, x)

    def bind(self, sub):
        mv1 = sub.as_matvec(self.op)
        mvb = sub.as_block_matvec(self.op)

        def apply(x):
            return self._apply_with(mv1 if x.dim() == 1 else mvb, x)
        return apply

    @staticmethod
    def from_operator(op, degree: int = 2, omega: float = 1.0
                      ) -> "NeumannPreconditioner":
        return NeumannPreconditioner(
            op, JacobiPreconditioner.from_operator(op).inv_diag,
            degree, omega)


def neumann(op, degree: int = 2, omega: float = 1.0
            ) -> NeumannPreconditioner:
    """Factory: degree-``degree`` Neumann polynomial preconditioner."""
    return NeumannPreconditioner.from_operator(op, degree, omega)
