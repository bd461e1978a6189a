"""CUDA kernels: ELLPACK SpMV.

Counterparts of ``repro/kernels/spmv_ell.py:spmv_ell_pallas`` and
``spmv_ell_batched_pallas``; the sources are ``src/repro_torch/csrc/
spmv_ell.cu`` and ``spmv_ell_batched.cu``.
``y[r] = Σ_j values[r,j]·x[cols[r,j]]`` with int32 ``cols``, one thread per
row gathering ``x`` from device memory; for an ``(n, m)`` block ``x``, one
thread per element, the m threads of a row sharing its values and cols.

The TPU kernels need the band below 512 (their three-block VMEM window);
these gather from device memory and take any ELL matrix, so the port's
``"cuda"`` substrate sends every ELL operator here.  Call it through
:func:`repro_torch.kernels.ops.spmv_ell`, which checks the operands and
dispatches by device.
"""
from __future__ import annotations

import torch

from . import _build

NAME = "spmv_ell"
NAME_BATCHED = "spmv_ell_batched"


def spmv_ell_cuda(values, cols, x) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands; returns ``y`` (n,)."""
    n, k = values.shape
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    lib = _build.library()
    fn = lib.repro_spmv_ell_f64 if x.dtype == torch.float64 \
        else lib.repro_spmv_ell_f32
    _build.launch(NAME, fn, values.data_ptr(), cols.data_ptr(), x.data_ptr(),
                  y.data_ptr(), n, k,
                  torch.cuda.current_stream(x.device).cuda_stream)
    return y


def spmv_ell_batched_cuda(values, cols, x) -> torch.Tensor:
    """Launch the batched kernel on checked CUDA operands; returns ``Y``
    (n, m) for the (n, m) block ``x``."""
    n, k = values.shape
    m = x.shape[1]
    y = torch.empty((n, m), dtype=x.dtype, device=x.device)
    lib = _build.library()
    fn = lib.repro_spmv_ell_batched_f64 if x.dtype == torch.float64 \
        else lib.repro_spmv_ell_batched_f32
    _build.launch(NAME_BATCHED, fn, values.data_ptr(), cols.data_ptr(),
                  x.data_ptr(), y.data_ptr(), n, m, k,
                  torch.cuda.current_stream(x.device).cuda_stream)
    return y
