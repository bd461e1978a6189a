"""CUDA kernels: the block-Jacobi preconditioner's apply.

Counterparts of ``repro/kernels/precond_apply.py:block_jacobi_apply_pallas``
and ``block_jacobi_apply_batched_pallas``; the sources are
``src/repro_torch/csrc/block_jacobi_apply.cu`` (``(n,)`` vectors) and
``block_jacobi_apply_batched.cu`` (``(n, m)`` blocks).
``y_g = B_g x_g`` for every row block ``g`` of the pre-inverted ``(nb, bs,
bs)`` diagonal blocks: a block of threads per row block (and, batched, per
tile of 8 columns), ``x_g`` staged in shared memory, a group of lanes per
row of ``B_g`` and a fixed-order shuffle sum, so a repeat is bitwise equal.
Any ``nb >= 1`` and ``bs`` (the TPU kernel's group padding has no
counterpart).  Call them through
:func:`repro_torch.kernels.ops.block_jacobi_apply`, which checks the
operands, dispatches by device and shape, and keeps the shared block
(``nb == 1``) on one ``torch.matmul``.
"""
from __future__ import annotations

import torch

from . import _build

NAME = "block_jacobi_apply"
NAME_BATCHED = "block_jacobi_apply_batched"


def _stream(v: torch.Tensor) -> int:
    return torch.cuda.current_stream(v.device).cuda_stream


def block_jacobi_apply_cuda(inv_blocks, x) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands; returns ``y`` (n,)."""
    nb, bs, _ = inv_blocks.shape
    y = torch.empty_like(x)
    lib = _build.library()
    fn = lib.repro_block_jacobi_apply_f64 if x.dtype == torch.float64 \
        else lib.repro_block_jacobi_apply_f32
    _build.launch(NAME, fn, inv_blocks.data_ptr(), x.data_ptr(),
                  y.data_ptr(), nb, bs, _stream(x))
    return y


def block_jacobi_apply_batched_cuda(inv_blocks, x) -> torch.Tensor:
    """Launch the batched kernel on checked CUDA operands; returns ``Y``
    (n, m) for the (n, m) block ``x``."""
    nb, bs, _ = inv_blocks.shape
    y = torch.empty_like(x)
    lib = _build.library()
    fn = lib.repro_block_jacobi_apply_batched_f64 \
        if x.dtype == torch.float64 \
        else lib.repro_block_jacobi_apply_batched_f32
    _build.launch(NAME_BATCHED, fn, inv_blocks.data_ptr(), x.data_ptr(),
                  y.data_ptr(), nb, bs, x.shape[1], _stream(x))
    return y
