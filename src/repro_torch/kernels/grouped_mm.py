"""CUDA kernel: the grouped matrix product of the dropless MoE dispatch.

``grouped_mm(x (R, K), w (E, K, N), offsets (E + 1,)) -> y (R, N)``: the
rows ``offsets[e]:offsets[e + 1]`` of ``x`` (sorted by expert) times
``w[e]``, the sums in f32 and the result in x's dtype, as
``jax.lax.ragged_dot`` gives it.  It replaces no Pallas kernel: it stands
in for ``jax.lax.ragged_dot`` in the JAX package's sort dispatch
(``src/repro/models/moe.py`` ``_moe_sort``), which XLA lowers on its own.
The port writes it by hand so that the offsets stay on the device: the
kernel reads them itself, its grid depends on ``(R, E, N)`` alone, and a
decode step that calls it captures as one CUDA graph whatever the routing
(``src/repro_torch/csrc/grouped_mm.cu`` says what bounds it and how).

On the card it takes bfloat16 operands with K and N multiples of 8, int64
offsets and up to about 4 M rows (``MAX_TILES``); :func:`plain` is its
plain version, a loop over the groups that reads the offsets to the host,
the CPU path and the card's oracle.
Both require ``offsets[0] == 0``, ``offsets[E] == R`` and non-decreasing
offsets; the kernel cannot check them without a host read and trusts
them, the plain version checks.  Call it through
:func:`repro_torch.kernels.ops.grouped_mm`, which checks the operands and
dispatches by device.
"""
from __future__ import annotations

import torch

from . import _build

NAME = "grouped_mm"
#: the operands' dtypes on the card
DTYPES = (torch.bfloat16,)
#: K and N must be multiples of this on the card (16-byte copies)
ALIGN = 8
#: rows of the kernel's tiles, and the most tiles its grid holds: at most
#: ceil(R / TILE_ROWS) + min(E, R) tiles, one grid row each
TILE_ROWS = 64
MAX_TILES = 65535


def plain(x: torch.Tensor, w: torch.Tensor,
          offsets: torch.Tensor) -> torch.Tensor:
    """The grouped product as one product per group, the offsets read to
    the host: each group's rows times its matrix with the sums in f32
    (exact products of bf16 values), rounded to x's dtype."""
    R, N = x.shape[0], w.shape[2]
    bounds = offsets.tolist()                          # the host read
    if bounds[0] != 0 or bounds[-1] != R or any(
            a > b for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"grouped_mm: offsets must rise from 0 to {R}, got "
                         f"{bounds}")
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = x.new_empty((R, N))
    for e, (start, end) in enumerate(zip(bounds, bounds[1:])):
        if end > start:
            y[start:end] = (x[start:end].to(acc) @ w[e].to(acc)).to(x.dtype)
    return y


def weight_grad(x: torch.Tensor, dy: torch.Tensor, offsets: torch.Tensor,
                dtype) -> torch.Tensor:
    """``dw[e] = x_e^T dy_e`` over each group's rows, in f32, cast to
    ``dtype``: the weight gradient of the grouped product (plain PyTorch,
    the offsets read to the host, on either device)."""
    bounds = offsets.tolist()
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    dw = torch.zeros((len(bounds) - 1, x.shape[1], dy.shape[1]), dtype=acc,
                     device=x.device)
    for e, (start, end) in enumerate(zip(bounds, bounds[1:])):
        if end > start:
            dw[e] = x[start:end].to(acc).T @ dy[start:end].to(acc)
    return dw.to(dtype)


def grouped_mm_cuda(x: torch.Tensor, w: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands; returns a fresh ``(R,
    N)`` tensor."""
    R, K = x.shape
    E, _, N = w.shape
    y = torch.empty((R, N), dtype=x.dtype, device=x.device)
    lib = _build.library()
    _build.launch(NAME, lib.repro_grouped_mm_bf16, x.data_ptr(),
                  w.data_ptr(), offsets.data_ptr(), y.data_ptr(), R, K, N, E,
                  torch.cuda.current_stream(x.device).cuda_stream)
    return y
