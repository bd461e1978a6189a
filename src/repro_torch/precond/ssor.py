"""SSOR preconditioner for the matrix-free 7-point stencil operator (PyTorch
port of ``repro.precond.ssor``).

M_SSOR = 1/(omega(2-omega)) (D + omega L) D^{-1} (D + omega U) with the
stencil's natural splitting: D = c0 I, L the lower shifts (x-, y-, z-) and
U the upper shifts (x+, y+, z+).  The two triangular solves are applied as
truncated Neumann expansions

    (D + omega L)^{-1}  ~=  (sum_k (-omega D^{-1} L)^k) D^{-1},  k <= terms

("truncated Neumann SSOR"), so the result is a fixed linear operator built
from stencil shifts, with no inner product, for ``(n,)`` vectors and
``(n, m)`` blocks alike.  Plain PyTorch shifts on either substrate, as in
the JAX package (no kernel there either).
"""
from __future__ import annotations

import dataclasses

import torch

from .base import Preconditioner


@dataclasses.dataclass(frozen=True, repr=False)
class SSORPreconditioner(Preconditioner):
    """Truncated-Neumann SSOR for a 7-point stencil (c, nx, ny, nz)."""

    c: torch.Tensor     # the 7 stencil coefficients
    nx: int
    ny: int
    nz: int
    omega: float = 1.0
    terms: int = 2      # Neumann terms per triangular solve

    name = "ssor"

    def _shift_sum(self, u, lower: bool):
        """L u (lower=True) or U u on the (nx, ny, nz, ...) grid."""
        c = self.c
        zx = torch.zeros_like(u[:1])
        zy = torch.zeros_like(u[:, :1])
        zz = torch.zeros_like(u[:, :, :1])
        if lower:
            um = torch.cat([zx, u[:-1]], dim=0)
            vm = torch.cat([zy, u[:, :-1]], dim=1)
            wm = torch.cat([zz, u[:, :, :-1]], dim=2)
            return c[1] * um + c[3] * vm + c[5] * wm
        up = torch.cat([u[1:], zx], dim=0)
        vp = torch.cat([u[:, 1:], zy], dim=1)
        wp = torch.cat([u[:, :, 1:], zz], dim=2)
        return c[2] * up + c[4] * vp + c[6] * wp

    def _tri_solve(self, u, lower: bool):
        """Truncated Neumann series for (D + omega T)^{-1} u."""
        d_inv = 1.0 / self.c[0]
        v = d_inv * u
        acc = v
        for _ in range(self.terms):
            v = -self.omega * d_inv * self._shift_sum(v, lower)
            acc = acc + v
        return acc

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        u = x.reshape(self.nx, self.ny, self.nz, *x.shape[1:])
        w = self._tri_solve(u, lower=True)
        w = self.c[0] * w                         # D
        w = self._tri_solve(w, lower=False)
        w = self.omega * (2.0 - self.omega) * w
        return w.reshape(x.shape)

    @staticmethod
    def from_operator(op, omega: float = 1.0, terms: int = 2
                      ) -> "SSORPreconditioner":
        from ..core.linear_operator import Stencil7Operator
        if not isinstance(op, Stencil7Operator):
            raise TypeError(
                "ssor is the Stencil7Operator preconditioner; got "
                f"{type(op).__name__} (use jacobi/block_jacobi/neumann)")
        return SSORPreconditioner(op.c, op.nx, op.ny, op.nz, omega, terms)


def ssor(op, omega: float = 1.0, terms: int = 2) -> SSORPreconditioner:
    """Factory: truncated-Neumann SSOR for a Stencil7 operator."""
    return SSORPreconditioner.from_operator(op, omega, terms)
