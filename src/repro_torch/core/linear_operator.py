"""Linear operators for the Krylov solvers (PyTorch port of
``repro.core.linear_operator``).

Every operator exposes ``matvec``, ``diagonal``, ``shape``, ``dtype`` and
``device``; its tensors all live on one device.  ``matvec`` takes an
``(n,)`` vector or an ``(n, m)`` block of columns: the batch dimension is
written out (the JAX package lifts with ``vmap``), so a block matvec costs
the same number of launches whatever m is.

* :class:`DenseOperator` — dense matrix (small systems / tests).
* :class:`CSROperator` — compressed sparse row: gather + ``index_add_``.
* :class:`ELLOperator` — ELLPACK, ``k`` nonzeros per row as two dense
  ``(n, k)`` tensors, ``cols`` int32; the format the CUDA SpMV consumes.
* :class:`Stencil7Operator` — matrix-free 7-point stencil with zero
  Dirichlet boundaries.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import MatVec


@dataclasses.dataclass(frozen=True)
class DenseOperator:
    """Dense matrix operator (small systems / tests)."""

    a: torch.Tensor

    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.a @ x

    def diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.a)


@dataclasses.dataclass(frozen=True)
class CSROperator:
    """CSR sparse operator.

    ``data``/``indices`` are nnz-length; ``row_ids`` is the expanded row
    index per nonzero, so matvec is a gather plus ``index_add_``.
    """

    data: torch.Tensor      # (nnz,)
    indices: torch.Tensor   # (nnz,) int32 column ids
    row_ids: torch.Tensor   # (nnz,) int32 row ids
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def _segment_sum(self, vals: torch.Tensor, seg: torch.Tensor):
        out = torch.zeros((self.n,) + vals.shape[1:], dtype=vals.dtype,
                          device=vals.device)
        return out.index_add_(0, seg, vals)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        data = self.data if x.dim() == 1 else self.data[:, None]
        return self._segment_sum(data * x[self.indices], self.row_ids)

    def diagonal(self) -> torch.Tensor:
        on_diag = torch.where(self.indices == self.row_ids, self.data,
                              torch.zeros_like(self.data))
        return self._segment_sum(on_diag, self.row_ids)


@dataclasses.dataclass(frozen=True)
class ELLOperator:
    """ELLPACK operator: fixed k nonzeros per row, padded with zeros.

    ``values`` is ``(n, k)`` float, ``cols`` ``(n, k)`` int32.  A padding
    entry has value 0, so any in-range column works for it.  Columns are
    checked to lie in ``[0, n)`` once, at construction: the CUDA SpMV
    gathers ``x[cols]`` without a bounds check.
    """

    values: torch.Tensor  # (n, k)
    cols: torch.Tensor    # (n, k) int32
    n: int

    def __post_init__(self):
        if self.values.dim() != 2 or self.values.shape != self.cols.shape \
                or self.values.shape[0] != self.n:
            raise ValueError(
                f"ELL values/cols must both be ({self.n}, k); got "
                f"{tuple(self.values.shape)} and {tuple(self.cols.shape)}")
        if self.cols.dtype != torch.int32:
            raise TypeError(f"ELL cols must be int32, got {self.cols.dtype}")
        if self.values.device != self.cols.device:
            raise ValueError("ELL values and cols lie on different devices")
        if self.cols.numel() and not bool(
                ((self.cols >= 0) & (self.cols < self.n)).all()):
            raise ValueError(f"ELL cols must lie in [0, {self.n})")

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def k(self) -> int:
        return self.values.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            return torch.einsum("rk,rkm->rm", self.values, x[self.cols])
        return (self.values * x[self.cols]).sum(dim=1)

    def diagonal(self) -> torch.Tensor:
        row = torch.arange(self.n, device=self.device)[:, None]
        return torch.where(self.cols == row, self.values,
                           torch.zeros_like(self.values)).sum(dim=1)

    @staticmethod
    def from_csr(op: CSROperator) -> "ELLOperator":
        """Convert (host-side, in numpy) a CSR operator to padded ELL on the
        CSR operator's device."""
        data = op.data.cpu().numpy()
        indices = op.indices.cpu().numpy()
        row_ids = op.row_ids.cpu().numpy()
        n = op.n
        counts = np.bincount(row_ids, minlength=n)
        kk = int(counts.max())
        values = np.zeros((n, kk), dtype=data.dtype)
        cols = np.zeros((n, kk), dtype=np.int32)
        # position of each nnz within its row
        pos = np.arange(len(data)) - np.concatenate(
            ([0], np.cumsum(counts)[:-1]))[row_ids]
        values[row_ids, pos] = data
        cols[row_ids, pos] = indices
        return ELLOperator(torch.from_numpy(values).to(op.device),
                           torch.from_numpy(cols).to(op.device), n)


@dataclasses.dataclass(frozen=True)
class Stencil7Operator:
    """Matrix-free 7-point stencil on an (nx, ny, nz) grid with zero
    Dirichlet boundaries.  ``c`` holds the 7 coefficients
    ``[center, xm, xp, ym, yp, zm, zp]``; vectors are flattened row-major.
    """

    c: torch.Tensor  # (7,)
    nx: int
    ny: int
    nz: int

    @property
    def n(self):
        return self.nx * self.ny * self.nz

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.c.dtype

    @property
    def device(self):
        return self.c.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        u = x.reshape(self.nx, self.ny, self.nz, *x.shape[1:])
        c = self.c
        out = c[0] * u
        # zero-Dirichlet shifts (no wraparound): pad + slice
        zx = torch.zeros_like(u[:1])
        um = torch.cat([zx, u[:-1]], dim=0)   # u[i-1]
        up = torch.cat([u[1:], zx], dim=0)    # u[i+1]
        zy = torch.zeros_like(u[:, :1])
        vm = torch.cat([zy, u[:, :-1]], dim=1)
        vp = torch.cat([u[:, 1:], zy], dim=1)
        zz = torch.zeros_like(u[:, :, :1])
        wm = torch.cat([zz, u[:, :, :-1]], dim=2)
        wp = torch.cat([u[:, :, 1:], zz], dim=2)
        out = out + c[1] * um + c[2] * up + c[3] * vm + c[4] * vp \
            + c[5] * wm + c[6] * wp
        return out.reshape(x.shape)

    def diagonal(self) -> torch.Tensor:
        return self.c[0].expand(self.n).clone()


def as_matvec(op) -> MatVec:
    """Accept an operator object, a dense matrix, or a callable."""
    if callable(op) and not hasattr(op, "matvec"):
        return op
    if hasattr(op, "matvec"):
        return op.matvec
    a = torch.as_tensor(op)
    return lambda x: a @ x


def batched_matvec(matvec: MatVec) -> MatVec:
    """Lift a single-vector matvec ``(n,) -> (n,)`` to ``(n, m)`` column
    blocks, one call per column (what ``vmap`` does in the JAX package)."""
    return lambda X: torch.stack([matvec(X[:, j]) for j in range(X.shape[1])],
                                 dim=1)


def as_block_matvec(op) -> MatVec:
    """Operator -> column-blocked matvec ``(n, m) -> (n, m)``: an operator's
    or a dense matrix's own block matvec; a bare callable, which may take
    only ``(n,)`` vectors, is lifted column by column."""
    if callable(op) and not hasattr(op, "matvec"):
        return batched_matvec(op)
    return as_matvec(op)
