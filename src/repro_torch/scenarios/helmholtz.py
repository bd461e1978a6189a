"""Complex-shifted Helmholtz operators: the proof-of-plugin class (PyTorch
port of ``repro.scenarios.helmholtz``).

The complex-shifted Helmholtz system (van Gijzen et al.'s shifted-
Laplacian family)::

    (L - (k^2 + i eps) I) x_c = b_c

with ``L`` the 7-point Laplacian.  The solvers and kernels of
:mod:`repro_torch.core` are real-dtype, so this plugin registers the system
in its REAL-EQUIVALENT block form, acting on stacked ``[Re x; Im x]`` of
length 2n::

    [[A_r,  eps I],        A_r = L - k^2 I   (a Stencil7Operator)
     [-eps I,  A_r]]

whose eigenvalues are ``lambda(A_r) -+ i eps``: modulus bounded below by
``eps`` even where the shifted Laplacian is indefinite, and decisively
non-symmetric, the BiCGSafe regime.

Everything here (the operator, the builder, the complex-residual oracle,
the expected contract outcomes) registers from the plugin side; no file
under ``repro_torch/core/`` knows of it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.linear_operator import Stencil7Operator
from ..core.types import resolve_device
from .registry import _host, register_operator_class

__all__ = ["HelmholtzShiftedOperator"]


@dataclasses.dataclass(frozen=True)
class HelmholtzShiftedOperator:
    """Real-equivalent form of ``L - (k^2 + i eps) I`` on a 3-D grid.

    ``stencil`` is the REAL part ``A_r = L - k^2 I`` (center coefficient
    ``6 - k^2``); ``eps`` the imaginary shift, a 0-d tensor.  Vectors are
    the stacked real/imaginary halves, length ``2 * stencil.n``; ``matvec``
    takes an ``(n,)`` vector or an ``(n, m)`` block of columns, so the
    batched solves apply it to the whole block at once.  Two stencil
    applications plus the scalar coupling, matrix-free; a dataclass of
    tensors, so sessions bound to it are fingerprinted by content and
    cached like any core operator.
    """

    stencil: Stencil7Operator
    eps: torch.Tensor                   # 0-d imaginary shift

    @property
    def n(self):
        return 2 * self.stencil.n

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.stencil.dtype

    @property
    def device(self):
        return self.stencil.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        half = self.stencil.n
        xr, xi = x[:half], x[half:]
        yr = self.stencil.matvec(xr) + self.eps * xi
        yi = self.stencil.matvec(xi) - self.eps * xr
        return torch.cat([yr, yi])

    def diagonal(self) -> torch.Tensor:
        d = self.stencil.diagonal()
        return torch.cat([d, d])


def _helmholtz_oracle(problem, B, X, tol: float) -> dict:
    """Verify solutions of the REAL-EQUIVALENT solve against the COMPLEX
    system they encode.

    Reassembles ``x_c = Re + i Im`` per column in numpy complex arithmetic,
    applies ``L - (k^2 + i eps) I`` through the real stencil (on its
    device, the results copied to the host), and checks the complex true
    residual: a sign error in the block coupling (the classic
    real-equivalent bug) fails verification even when the real residual
    looks converged.
    """
    op, _, x_true = problem
    half = op.stencil.n
    eps = complex(0.0, float(op.eps))

    def stencil(v):
        return _host(op.stencil.matvec(torch.as_tensor(
            np.ascontiguousarray(v), device=op.device)))

    def apply_c(z):
        return stencil(z.real) + 1j * stencil(z.imag) - eps * z

    Bc = np.asarray(B[:half]) + 1j * np.asarray(B[half:])
    Xc = np.asarray(X[:half]) + 1j * np.asarray(X[half:])
    res = np.stack([Bc[:, j] - apply_c(Xc[:, j])
                    for j in range(Xc.shape[1])], axis=1)
    bnorm = np.linalg.norm(Bc, axis=0)
    relres = np.linalg.norm(res, axis=0) / np.where(bnorm == 0, 1, bnorm)
    detail = {"relres_complex": float(relres.max())}
    if x_true is not None:
        xt = _host(x_true)
        xtc = xt[:half] + 1j * xt[half:]          # (1 + i) * ones
        detail["x_err_complex"] = float(np.abs(Xc[:, 0] - xtc).max())
    return {"ok": bool(relres.max() <= 50 * tol), **detail}


# Expected contract outcomes: the block operator composes stencil
# applications with NO reduction of its own, so every cell keeps the
# paper's per-method expected matrix: one tagged fused reduction per
# iteration, overlap-edge free, and (on the cuda substrate) the
# operator-independent fused-phase kernels.  Declared explicitly empty: a
# plugin whose operators legitimately deviate would list the deltas here
# and the audit would hold it to them.
@register_operator_class(
    "helmholtz_shifted", oracle=_helmholtz_oracle, contract_overrides={},
    mesh_capable=False,
    description="complex-shifted Helmholtz, real-equivalent 2x2 block "
                "form (wave-equation kind)")
def _build(nx: int = 8, ny: int = 0, nz: int = 0,
           shift: float = 0.3, eps: float = 0.6, device=None):
    """Builder: ``shift`` is k^2 (0 -> pure Laplacian + rotation); ``eps``
    the imaginary shift that bounds the spectrum away from 0.  ``ny``/``nz``
    default (0) to ``nx``."""
    ny, nz = ny or nx, nz or nx
    dev = resolve_device(device)
    c = torch.tensor([6.0 - shift, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0],
                     dtype=torch.float64, device=dev)
    stencil = Stencil7Operator(c, nx, ny, nz)
    op = HelmholtzShiftedOperator(
        stencil, torch.tensor(eps, dtype=torch.float64, device=dev))
    x_true = torch.ones(op.n, dtype=op.dtype, device=dev)  # (1 + i) * ones
    b = op.matvec(x_true)
    return op, b, x_true
