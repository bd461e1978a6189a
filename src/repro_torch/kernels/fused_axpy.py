"""CUDA kernels: p-BiCGSafe's fused vector-update phase.

Counterparts of ``repro/kernels/fused_axpy.py:fused_axpy_pallas`` and
``fused_axpy_batched_pallas``; the sources are
``src/repro_torch/csrc/fused_axpy.cu`` and ``fused_axpy_batched.cu``.
Alg. 3.1 lines 23-32 in one pass: 12 input vectors (``IN_ORDER``) and the
coefficients ``(alpha, beta, zeta, eta)`` in, 10 vectors (``OUT_ORDER``)
out, one thread per element.  The batched kernel takes ``(n, m)`` blocks,
``(4, m)`` per-column coefficients and an optional ``(m,)`` mask that
freezes columns in the kernel.  Coefficients and mask are read from device
tensors, so the host never reads them back.  Call them through
:func:`repro_torch.kernels.ops.fused_axpy`, which checks the operands and
dispatches by device and shape.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "fused_axpy"
NAME_BATCHED = "fused_axpy_batched"
IN_ORDER = ("r", "p", "u", "t", "y", "z", "s", "l", "g", "w", "x", "As")
OUT_ORDER = ("p", "o", "u", "q", "w", "t", "z", "y", "x", "r")
#: outputs with an input of the same name: what a frozen column keeps in the
#: multi-RHS phase (``o`` and ``q`` have no state of their own: the solver
#: masks their consumers)
MASKED_OUT = ("p", "u", "w", "t", "z", "y", "x", "r")


def _pointers(vecs: dict, outs: dict):
    ins = (ctypes.c_void_p * len(IN_ORDER))(
        *(vecs[k].data_ptr() for k in IN_ORDER))
    outp = (ctypes.c_void_p * len(OUT_ORDER))(
        *(outs[k].data_ptr() for k in OUT_ORDER))
    return ins, outp


def fused_axpy_cuda(vecs: dict, scal: torch.Tensor) -> dict:
    """Launch the kernel on checked CUDA operands; ``scal`` is the (4,)
    coefficient tensor of the vectors' dtype on their device."""
    ref = vecs["r"]
    outs = {k: torch.empty_like(ref) for k in OUT_ORDER}
    lib = _build.library()
    fn = lib.repro_fused_axpy_f64 if ref.dtype == torch.float64 \
        else lib.repro_fused_axpy_f32
    _build.launch(NAME, fn, *_pointers(vecs, outs), scal.data_ptr(),
                  ref.numel(), torch.cuda.current_stream(ref.device)
                  .cuda_stream)
    return outs


def fused_axpy_batched_cuda(vecs: dict, scal: torch.Tensor, mask) -> dict:
    """Launch the batched kernel on checked ``(n, m)`` CUDA operands;
    ``scal`` is the contiguous (4, m) coefficient tensor of the blocks'
    dtype, ``mask`` a contiguous (m,) bool tensor or ``None`` (every
    column advances), both on the blocks' device."""
    ref = vecs["r"]
    n, m = ref.shape
    outs = {k: torch.empty_like(ref) for k in OUT_ORDER}
    lib = _build.library()
    fn = lib.repro_fused_axpy_batched_f64 if ref.dtype == torch.float64 \
        else lib.repro_fused_axpy_batched_f32
    _build.launch(NAME_BATCHED, fn, *_pointers(vecs, outs), scal.data_ptr(),
                  None if mask is None else mask.data_ptr(), n, m,
                  torch.cuda.current_stream(ref.device).cuda_stream)
    return outs
