"""CUDA kernels: the paper's single fused inner-product phase.

Counterparts of ``repro/kernels/fused_dots.py:fused_dots_pallas`` and
``fused_dots_batched_pallas``; the sources are
``src/repro_torch/csrc/fused_dots.cu`` and ``fused_dots_batched.cu``.  One
pass over ``(s, y, r, t_prev, r0*)`` gives the 9 dots
``[s·s, y·y, s·y, s·r, y·r, rs·r, rs·s, rs·t, r·r]`` (per column, ``(9, m)``,
for ``(n, m)`` blocks): block partials in registers, then a second pass in a
fixed order, so the result repeats bitwise from run to run.  Call them
through :func:`repro_torch.kernels.ops.fused_dots`, which checks the
operands and dispatches by device and shape.
"""
from __future__ import annotations

import torch

from . import _build

NAME = "fused_dots"
NAME_BATCHED = "fused_dots_batched"
NDOTS = 9
THREADS = 256        # kThreads in csrc/fused_dots.cu
MAX_BLOCKS = 1056    # 8 resident blocks of 256 threads on each of 132 SMs


def num_blocks(n: int, rows_per_block: int = THREADS) -> int:
    """Blocks of the partial-sum kernel: one per ``rows_per_block`` rows
    (256 for one vector), at most ``MAX_BLOCKS`` (each thread then loops
    over several rows)."""
    return max(1, min(MAX_BLOCKS, -(-n // rows_per_block)))


def tile_width(m: int) -> int:
    """Columns a block of the batched kernel covers: all m up to 256 (its
    256 threads then take ``256 // m`` rows per pass)."""
    return min(m, THREADS)


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


def fused_dots_batched_cuda(s, y, r, t, rs) -> torch.Tensor:
    """Launch the batched kernel on checked ``(n, m)`` CUDA operands;
    returns the (9, m) per-column dots."""
    n, m = s.shape
    width = tile_width(m)
    nb = num_blocks(n, THREADS // width)
    partials = torch.empty((nb, NDOTS, m), dtype=s.dtype, device=s.device)
    out = torch.empty((NDOTS, m), dtype=s.dtype, device=s.device)
    lib = _build.library()
    fn = lib.repro_fused_dots_batched_f64 if s.dtype == torch.float64 \
        else lib.repro_fused_dots_batched_f32
    _build.launch(NAME_BATCHED, fn, s.data_ptr(), y.data_ptr(), r.data_ptr(),
                  t.data_ptr(), rs.data_ptr(), n, m, width,
                  partials.data_ptr(), nb, out.data_ptr(),
                  torch.cuda.current_stream(s.device).cuda_stream)
    return out
