"""CUDA kernel: ELLPACK SpMV.

Counterpart of ``repro/kernels/spmv_ell.py:spmv_ell_pallas``; the source is
``src/repro_torch/csrc/spmv_ell.cu``.  ``y[r] = Σ_j values[r,j]·x[cols[r,j]]``
with int32 ``cols``, one thread per row gathering ``x`` from device memory.

The TPU kernel needs the band below 512 (its three-block VMEM window); this
one gathers from device memory and takes any ELL matrix, so the port's
``"cuda"`` substrate sends every ELL operator here.  Call it through
:func:`repro_torch.kernels.ops.spmv_ell`, which checks the operands and
dispatches by device.
"""
from __future__ import annotations

import torch

from . import _build

NAME = "spmv_ell"


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
