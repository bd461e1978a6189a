"""Block-Jacobi preconditioner: pre-inverted dense diagonal blocks (PyTorch
port of ``repro.precond.block_jacobi``).

M = blockdiag(A_11, ..., A_bb) over contiguous row blocks of size ``bs``.
The set-up extracts and inverts every block on the host, in numpy, as the
JAX package does, and moves the blocks to the operator's device once; the
apply is then a batched dense ``(bs, bs) @ (bs,)`` product per block.  On
the ``"cuda"`` substrate it runs through the hand-written block-apply
kernels (:mod:`repro_torch.kernels.precond_apply`), for ``(n,)`` vectors
and ``(n, m)`` blocks.

``inv_blocks`` may be ``(1, bs, bs)``: one block shared by every row block
(the :class:`~repro_torch.core.linear_operator.Stencil7Operator` case,
whose z-line blocks are all the same tridiagonal matrix); its apply is one
``torch.matmul`` on either substrate (``ops.block_jacobi_apply``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .base import Preconditioner


@dataclasses.dataclass(frozen=True, repr=False)
class BlockJacobiPreconditioner(Preconditioner):
    """M^{-1} applied as pre-inverted dense diagonal blocks.

    ``inv_blocks`` is ``(nb, bs, bs)`` — or ``(1, bs, bs)`` for a block
    shared by all ``n // bs`` row blocks (constant-coefficient stencils).
    """

    inv_blocks: torch.Tensor

    name = "block_jacobi"

    @property
    def block_size(self) -> int:
        return self.inv_blocks.shape[-1]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        from ..kernels import ref
        return ref.block_jacobi_apply(self.inv_blocks, x)

    def bind(self, sub):
        if getattr(sub, "kernel_backed", False):
            from ..kernels import ops
            return functools.partial(ops.block_jacobi_apply, self.inv_blocks)
        return self.apply

    @staticmethod
    def from_operator(op, block_size: int | None = None
                      ) -> "BlockJacobiPreconditioner":
        """Extract and invert the diagonal blocks of ``op`` (set-up, on the
        host).  ``block_size`` must divide n; default: the stencil's ``nz``
        (z-line blocks), else the largest divisor of n up to 64.

        The blocks are inverted in the operator's dtype, as in the JAX
        package; a singular block (e.g. from an empty row) gets the
        identity instead of a raw ``LinAlgError``."""
        blocks = _extract_diag_blocks(op, block_size)
        inv = torch.from_numpy(np.ascontiguousarray(
            _inv_blocks_guarded(blocks)))
        return BlockJacobiPreconditioner(
            inv.to(device=op.device, dtype=op.dtype).contiguous())


def _inv_blocks_guarded(blocks: np.ndarray) -> np.ndarray:
    """Batched inverse with identity substituted for singular blocks."""
    try:
        return np.linalg.inv(blocks)
    except np.linalg.LinAlgError:
        inv = np.empty_like(blocks)
        for i, blk in enumerate(blocks):
            try:
                inv[i] = np.linalg.inv(blk)
            except np.linalg.LinAlgError:
                inv[i] = np.eye(blk.shape[0], dtype=blocks.dtype)
        return inv


def _default_block_size(n: int) -> int:
    # largest divisor of n up to 64, but strictly below n (a single
    # n-sized block would be a dense direct solve, not block-Jacobi)
    cap = min(64, max(1, n // 2))
    return next(s for s in range(cap, 0, -1) if n % s == 0)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _extract_diag_blocks(op, block_size: int | None) -> np.ndarray:
    """(nb, bs, bs) diagonal blocks — (1, bs, bs) when all are identical."""
    from ..core.linear_operator import (CSROperator, DenseOperator,
                                        ELLOperator, Stencil7Operator)

    if isinstance(op, Stencil7Operator):
        # z-lines are contiguous in the flattened index, so any bs | nz
        # yields the same tridiagonal block for every row block: c0 on the
        # diagonal, c5/c6 (z-/z+) on the off-diagonals.  ONE shared block.
        bs = op.nz if block_size is None else block_size
        if op.nz % bs:
            raise ValueError(f"block_size={bs} must divide nz={op.nz} "
                             "for Stencil7 block-Jacobi (z-line blocks)")
        c = _host(op.c)
        blk = np.zeros((bs, bs), dtype=c.dtype)
        idx = np.arange(bs)
        blk[idx, idx] = c[0]
        blk[idx[1:], idx[1:] - 1] = c[5]
        blk[idx[:-1], idx[:-1] + 1] = c[6]
        return blk[None]

    n = op.shape[0]
    bs = _default_block_size(n) if block_size is None else block_size
    if n % bs:
        raise ValueError(f"block_size={bs} must divide n={n}")
    nb = n // bs

    if isinstance(op, DenseOperator):
        a = _host(op.a)
        return a.reshape(nb, bs, nb, bs)[np.arange(nb), :, np.arange(nb), :]

    if isinstance(op, ELLOperator):
        vals = _host(op.values)
        cols = _host(op.cols).astype(np.int64)
        rows = np.repeat(np.arange(n), vals.shape[1])
        vals, cols = vals.reshape(-1), cols.reshape(-1)
    elif isinstance(op, CSROperator):
        vals = _host(op.data)
        cols = _host(op.indices).astype(np.int64)
        rows = _host(op.row_ids).astype(np.int64)
    else:
        raise TypeError(
            f"block_jacobi cannot extract diagonal blocks from "
            f"{type(op).__name__}; pass a Dense/CSR/ELL/Stencil7 operator "
            "or construct BlockJacobiPreconditioner directly")
    same = (rows // bs) == (cols // bs)
    # the entries of each block summed in float64 in the order they come,
    # as the JAX package's np.add.at into float64 zeros sums them; bincount
    # is the same sum without add.at's per-element cost (8.8 M entries at
    # full size)
    flat = (rows[same] * bs) + cols[same] % bs
    blocks = np.bincount(flat, weights=vals[same].astype(np.float64),
                         minlength=nb * bs * bs).reshape(nb, bs, bs)
    return blocks.astype(vals.dtype)


def block_jacobi(op, block_size: int | None = None
                 ) -> BlockJacobiPreconditioner:
    """Factory: block-Jacobi with pre-inverted dense diagonal blocks."""
    return BlockJacobiPreconditioner.from_operator(op, block_size)
