"""Synthetic test-problem generators (PyTorch port of
``repro.core.matrices``).

The same kinds as the JAX package, built with the same numpy RNG calls so
that a seed gives bitwise-equal arrays in both packages:

* :func:`poisson3d`            — SPD 7-point Laplacian            (≈ poisson3Db)
* :func:`convection_diffusion` — non-symmetric fluid dynamics     (≈ atmosmodd)
* :func:`anisotropic3d`        — badly scaled SPD                 (≈ s3dkq4m2)
* :func:`random_nonsym`        — generic non-symmetric sparse     (≈ xenon2 etc.)
* :func:`hard_nonsym`          — ill-conditioned non-symmetric (paper §5.2)
* :func:`spd_dense`, :func:`nonsym_dense` — small dense test matrices.

Every generator returns ``(operator, b, x_true)`` with the right-hand side
built so the exact solution is the all-ones vector (paper §5 protocol), on
``device`` (``None`` means ``"cuda"``).  :func:`stencil_to_ell` turns a
stencil operator into the ELL form the CUDA SpMV consumes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .linear_operator import (CSROperator, DenseOperator, ELLOperator,
                              Stencil7Operator)
from .types import resolve_device


def _np_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), dtype=dtype)).dtype


def _with_unit_solution(op):
    x_true = torch.ones(op.shape[0], dtype=op.dtype, device=op.device)
    b = op.matvec(x_true)
    return op, b, x_true


def _stencil(c, nx, ny, nz, dtype, device):
    c = torch.tensor(c, dtype=_torch_dtype(dtype),
                     device=resolve_device(device))
    return _with_unit_solution(Stencil7Operator(c, nx, ny, nz))


def poisson3d(nx: int = 16, ny: Optional[int] = None, nz: Optional[int] = None,
              dtype=torch.float64, device=None):
    """SPD 7-point Laplacian on an nx×ny×nz grid (Dirichlet)."""
    ny = ny or nx
    nz = nz or nx
    return _stencil([6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0],
                    nx, ny, nz, dtype, device)


def convection_diffusion(nx: int = 16, ny: Optional[int] = None,
                         nz: Optional[int] = None, peclet: float = 0.5,
                         dtype=torch.float64, device=None):
    """Non-symmetric convection-diffusion (upwinded convection in x and y).

    ``peclet`` controls the skew: 0 → symmetric Laplacian, larger → more
    non-normal.  The paper's dominant matrix kind (fluid dynamics).
    """
    ny = ny or nx
    nz = nz or nx
    px, py = peclet, 0.5 * peclet
    return _stencil([
        6.0 + px + py,
        -1.0 - px, -1.0,           # x- (upwind heavier), x+
        -1.0 - py, -1.0,           # y-, y+
        -1.0, -1.0,                # z-, z+
    ], nx, ny, nz, dtype, device)


def anisotropic3d(nx: int = 16, ny: Optional[int] = None,
                  nz: Optional[int] = None, eps: float = 1e-3,
                  dtype=torch.float64, device=None):
    """SPD but badly scaled: strong coupling in x, weak (eps) in y/z."""
    ny = ny or nx
    nz = nz or nx
    return _stencil([2.0 + 4.0 * eps, -1.0, -1.0, -eps, -eps, -eps, -eps],
                    nx, ny, nz, dtype, device)


def random_nonsym(n: int = 2000, nnz_per_row: int = 8, seed: int = 0,
                  diag_dominance: float = 1.2, dtype=torch.float64,
                  fmt: str = "csr", device=None):
    """Random sparse non-symmetric matrix, row-wise diagonally dominant
    (``fmt="csr"`` or ``"ell"``)."""
    device = resolve_device(device)
    dtype = _np_dtype(dtype)
    rng = np.random.default_rng(seed)
    k = nnz_per_row - 1  # off-diagonals per row
    cols = rng.integers(0, n, size=(n, k), dtype=np.int64)
    vals = rng.standard_normal((n, k)).astype(dtype)
    # remove accidental diagonal hits
    row = np.arange(n)[:, None]
    vals = np.where(cols == row, 0.0, vals)
    diag = diag_dominance * np.abs(vals).sum(axis=1) + 1e-3

    data = np.concatenate([diag[:, None], vals], axis=1).reshape(-1)
    indices = np.concatenate([row, cols], axis=1).reshape(-1).astype(np.int32)
    row_ids = np.repeat(np.arange(n, dtype=np.int32), nnz_per_row)
    op = CSROperator(torch.from_numpy(data).to(device),
                     torch.from_numpy(indices).to(device),
                     torch.from_numpy(row_ids).to(device), n)
    if fmt == "ell":
        op = ELLOperator.from_csr(op)
    return _with_unit_solution(op)


def hard_nonsym(n: int = 1500, seed: int = 3, scale_range: float = 8.0,
                dtype=torch.float64, device=None):
    """Ill-conditioned non-symmetric matrix (paper §5.2 regime): tridiagonal
    plus random couplings, rows scaled log-uniformly over
    ``10**±(scale_range/2)``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    scales = 10.0 ** rng.uniform(-scale_range / 2, scale_range / 2, size=n)
    a = np.zeros((n, n), dtype=_np_dtype(dtype))
    idx = np.arange(n)
    a[idx, idx] = 2.5
    a[idx[:-1], idx[:-1] + 1] = -1.0 + 0.3 * rng.standard_normal(n - 1)
    a[idx[1:], idx[1:] - 1] = -1.2 + 0.3 * rng.standard_normal(n - 1)
    # sparse long-range couplings
    nnz_extra = 4 * n
    ri = rng.integers(0, n, nnz_extra)
    ci = rng.integers(0, n, nnz_extra)
    a[ri, ci] += 0.2 * rng.standard_normal(nnz_extra)
    a = a * scales[:, None]
    return _with_unit_solution(DenseOperator(torch.from_numpy(a).to(device)))


def spd_dense(n: int = 200, seed: int = 0, cond: float = 1e4,
              dtype=torch.float64, device=None):
    """Small dense SPD matrix with prescribed condition number (tests)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, np.log10(cond), n)
    a = (q * eigs) @ q.T
    return _with_unit_solution(DenseOperator(
        torch.from_numpy(a.astype(_np_dtype(dtype))).to(device)))


def nonsym_dense(n: int = 200, seed: int = 1, skew: float = 0.4,
                 dtype=torch.float64, device=None):
    """Small dense non-symmetric, well-conditioned (tests)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((n, n)) / np.sqrt(n)
    a = np.eye(n) * 2.0 + 0.5 * (s + s.T) + skew * (s - s.T)
    return _with_unit_solution(DenseOperator(
        torch.from_numpy(a.astype(_np_dtype(dtype))).to(device)))


#: grid offsets of the stencil coefficients ``[center, xm, xp, ym, yp, zm, zp]``
STENCIL_OFFSETS = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                   (0, 0, -1), (0, 0, 1))


def stencil_ell_arrays(c, nx: int, ny: int, nz: int):
    """numpy ``(values, cols)`` of the 7-point stencil in ELL form (k = 7).

    Entry ``e`` of row ``r`` is the stencil's ``e``-th coefficient at the
    neighbour ``STENCIL_OFFSETS[e]``; a neighbour cut off by the Dirichlet
    boundary gets value 0 and column ``r`` itself.  Built in numpy on the
    host: it is set-up, not part of a solve.
    """
    c = np.asarray(c)
    n = nx * ny * nz
    row = np.arange(n, dtype=np.int64)
    gi, gj, gk = np.unravel_index(row, (nx, ny, nz))
    values = np.empty((n, 7), dtype=c.dtype)
    cols = np.empty((n, 7), dtype=np.int32)
    for e, (dx, dy, dz) in enumerate(STENCIL_OFFSETS):
        inside = ((gi + dx >= 0) & (gi + dx < nx) & (gj + dy >= 0)
                  & (gj + dy < ny) & (gk + dz >= 0) & (gk + dz < nz))
        cols[:, e] = np.where(inside, row + (dx * ny + dy) * nz + dz, row)
        values[:, e] = np.where(inside, c[e], 0.0)
    return values, cols


def stencil_to_ell(op: Stencil7Operator) -> ELLOperator:
    """The same matrix as ``op`` as an :class:`ELLOperator` on its device."""
    values, cols = stencil_ell_arrays(op.c.cpu().numpy(), op.nx, op.ny, op.nz)
    return ELLOperator(torch.from_numpy(values).to(op.device),
                       torch.from_numpy(cols).to(op.device), op.n)
