"""CUDA kernel: p-BiCGSafe's fused vector-update phase.

Counterpart of ``repro/kernels/fused_axpy.py:fused_axpy_pallas``; the source
is ``src/repro_torch/csrc/fused_axpy.cu``.  Alg. 3.1 lines 23-32 in one
pass: 12 input vectors (``IN_ORDER``) and the coefficients ``(alpha, beta,
zeta, eta)`` in, 10 vectors (``OUT_ORDER``) out, one thread per element.
The coefficients are read from a 4-element device tensor, so the host never
reads them back.  Call it through :func:`repro_torch.kernels.ops
.fused_axpy`, which checks the operands and dispatches by device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "fused_axpy"
IN_ORDER = ("r", "p", "u", "t", "y", "z", "s", "l", "g", "w", "x", "As")
OUT_ORDER = ("p", "o", "u", "q", "w", "t", "z", "y", "x", "r")


def fused_axpy_cuda(vecs: dict, scal: torch.Tensor) -> dict:
    """Launch the kernel on checked CUDA operands; ``scal`` is the (4,)
    coefficient tensor of the vectors' dtype on their device."""
    ref = vecs["r"]
    outs = {k: torch.empty_like(ref) for k in OUT_ORDER}
    ins = (ctypes.c_void_p * len(IN_ORDER))(
        *(vecs[k].data_ptr() for k in IN_ORDER))
    outp = (ctypes.c_void_p * len(OUT_ORDER))(
        *(outs[k].data_ptr() for k in OUT_ORDER))
    lib = _build.library()
    fn = lib.repro_fused_axpy_f64 if ref.dtype == torch.float64 \
        else lib.repro_fused_axpy_f32
    _build.launch(NAME, fn, ins, outp, scal.data_ptr(), ref.numel(),
                  torch.cuda.current_stream(ref.device).cuda_stream)
    return outs
