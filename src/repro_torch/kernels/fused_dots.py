"""CUDA kernels: the paper's single fused inner-product phase.

Counterparts of ``repro/kernels/fused_dots.py:fused_dots_pallas``,
``fused_dots_batched_pallas`` and their guarded forms
``fused_dots_health_pallas`` / ``fused_dots_health_batched_pallas``; the
sources are ``src/repro_torch/csrc/fused_dots.cu`` (``(n,)`` vectors) and
``fused_dots_batched.cu`` (``(n, m)`` blocks).  One pass over ``(s, y,
r, t_prev, r0*)`` gives the 9 dots ``[s·s, y·y, s·y, s·r, y·r, rs·r, rs·s,
rs·t, r·r]`` (per column, ``(9, m)``, for blocks); the guarded form also
reads the previous iterate ``x`` and adds ``x·x`` and the NaN/Inf probe
``Σ(s+y+t+rs+x)`` as rows 9 and 10.  Block partials in registers, then a
second pass in a fixed order, so the result repeats bitwise from run to
run, and rows 0-8 of the guarded form equal the 9-row form's bit for bit.
Call them through :func:`repro_torch.kernels.ops.fused_dots` and
:func:`~repro_torch.kernels.ops.fused_dots_health`, which check the
operands and dispatch by device and shape.
"""
from __future__ import annotations

import torch

from . import _build

NAME = "fused_dots"
NAME_BATCHED = "fused_dots_batched"
NAME_HEALTH = "fused_dots_health"
NAME_HEALTH_BATCHED = "fused_dots_health_batched"
NDOTS = 9
NDOTS_HEALTH = 11
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


def _stream(v: torch.Tensor) -> int:
    return torch.cuda.current_stream(v.device).cuda_stream


def _single(name: str, stem: str, rows: int, operands) -> torch.Tensor:
    s = operands[0]
    n = s.numel()
    nb = num_blocks(n)
    partials = torch.empty((nb, rows), dtype=s.dtype, device=s.device)
    out = torch.empty(rows, dtype=s.dtype, device=s.device)
    suffix = "f64" if s.dtype == torch.float64 else "f32"
    fn = getattr(_build.library(), f"{stem}_{suffix}")
    _build.launch(name, fn, *(v.data_ptr() for v in operands), n,
                  partials.data_ptr(), nb, out.data_ptr(), _stream(s))
    return out


def _batched(name: str, stem: str, rows: int, operands) -> torch.Tensor:
    s = operands[0]
    n, m = s.shape
    width = tile_width(m)
    nb = num_blocks(n, THREADS // width)
    partials = torch.empty((nb, rows, m), dtype=s.dtype, device=s.device)
    out = torch.empty((rows, m), dtype=s.dtype, device=s.device)
    suffix = "f64" if s.dtype == torch.float64 else "f32"
    fn = getattr(_build.library(), f"{stem}_{suffix}")
    _build.launch(name, fn, *(v.data_ptr() for v in operands), n, m, width,
                  partials.data_ptr(), nb, out.data_ptr(), _stream(s))
    return out


def fused_dots_cuda(s, y, r, t, rs) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands; returns the (9,) dots."""
    return _single(NAME, "repro_fused_dots", NDOTS, (s, y, r, t, rs))


def fused_dots_batched_cuda(s, y, r, t, rs) -> torch.Tensor:
    """Launch the batched kernel on checked ``(n, m)`` CUDA operands;
    returns the (9, m) per-column dots."""
    return _batched(NAME_BATCHED, "repro_fused_dots_batched", NDOTS,
                    (s, y, r, t, rs))


def fused_dots_health_cuda(s, y, r, t, rs, x) -> torch.Tensor:
    """Launch the guarded kernel on checked CUDA operands; returns the
    (11,) rows."""
    return _single(NAME_HEALTH, "repro_fused_dots_health", NDOTS_HEALTH,
                   (s, y, r, t, rs, x))


def fused_dots_health_batched_cuda(s, y, r, t, rs, x) -> torch.Tensor:
    """Launch the guarded batched kernel on checked ``(n, m)`` CUDA
    operands; returns the (11, m) per-column rows."""
    return _batched(NAME_HEALTH_BATCHED, "repro_fused_dots_health_batched",
                    NDOTS_HEALTH, (s, y, r, t, rs, x))
