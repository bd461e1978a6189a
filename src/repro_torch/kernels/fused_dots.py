"""CUDA kernel: the paper's single fused inner-product phase.

Counterpart of ``repro/kernels/fused_dots.py:fused_dots_pallas``; the source
is ``src/repro_torch/csrc/fused_dots.cu``.  One pass over
``(s, y, r, t_prev, r0*)`` gives the 9 dots
``[s·s, y·y, s·y, s·r, y·r, rs·r, rs·s, rs·t, r·r]``: block partials in
registers, then a one-block second pass in a fixed order, so the result
repeats bitwise from run to run.  Call it through :func:`repro_torch.kernels
.ops.fused_dots`, which checks the operands and dispatches by device.
"""
from __future__ import annotations

import torch

from . import _build

NAME = "fused_dots"
NDOTS = 9
THREADS = 256        # kThreads in csrc/fused_dots.cu
MAX_BLOCKS = 1056    # 8 resident blocks of 256 threads on each of 132 SMs


def num_blocks(n: int) -> int:
    """Blocks of the partial-sum kernel: one per 256 rows, at most
    ``MAX_BLOCKS`` (each thread then loops over several rows)."""
    return max(1, min(MAX_BLOCKS, -(-n // THREADS)))


def fused_dots_cuda(s, y, r, t, rs) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands; returns the (9,) dots."""
    n = s.numel()
    nb = num_blocks(n)
    partials = torch.empty((nb, NDOTS), dtype=s.dtype, device=s.device)
    out = torch.empty(NDOTS, dtype=s.dtype, device=s.device)
    lib = _build.library()
    fn = lib.repro_fused_dots_f64 if s.dtype == torch.float64 \
        else lib.repro_fused_dots_f32
    _build.launch(NAME, fn, s.data_ptr(), y.data_ptr(), r.data_ptr(),
                  t.data_ptr(), rs.data_ptr(), n, partials.data_ptr(), nb,
                  out.data_ptr(), torch.cuda.current_stream(s.device)
                  .cuda_stream)
    return out
