"""CUDA kernels: the block-Jacobi preconditioner's apply.

Counterparts of ``repro/kernels/precond_apply.py:block_jacobi_apply_pallas``
and ``block_jacobi_apply_batched_pallas``; the sources are
``src/repro_torch/csrc/block_jacobi_apply.cu`` (``(n,)`` vectors) and
``block_jacobi_apply_batched.cu`` (``(n, m)`` blocks).
``y_g = B_g x_g`` for every row block ``g`` of the pre-inverted ``(nb, bs,
bs)`` diagonal blocks, in a fixed summation order, so a repeat is bitwise
equal.  Any ``nb >= 1``, ``bs`` and ``m`` (the TPU kernel's group padding
has no counterpart).

The vector kernel takes a block of threads per row block.  The batched one
has routes, chosen by shape in :func:`batched_route` (see the source's
header): ``"bulk"`` streams B_g and X_g through a ring of shared-memory
stages (bulk asynchronous copies completing on mbarriers, one persistent
block per SM), ``"bulk_x_direct"`` streams B_g alone and reads X_g from
device memory (X_g too large for the ring), and ``"rows"`` is a block of
threads per (row block, tile of 8 columns) for every other shape.  Call
them through :func:`repro_torch.kernels.ops.block_jacobi_apply`, which
checks the operands, dispatches by device and shape, and keeps the shared
block (``nb == 1``) on one ``torch.matmul``.
"""
from __future__ import annotations

import torch

from . import _build

NAME = "block_jacobi_apply"
NAME_BATCHED = "block_jacobi_apply_batched"

#: the batched kernel's routes, by the number its C launcher takes
ROUTES = ("rows", "bulk", "bulk_x_direct")
#: the bulk routes' limits, as in block_jacobi_apply_batched.cu: the ring's
#: bytes, the chunks of B_g and the padding after each, the fewest rows
#: (fewer leave most of the 8 consumer warps idle)
RING_BYTES = 224 * 1024
CHUNKS = 8
CHUNK_PAD = {8: 32, 4: 16}      # by the element's bytes
MIN_BULK_ROWS = 32


def _stage_bytes(bs: int, m: int, item: int, x_staged: bool) -> int:
    b = CHUNKS * (-(-bs // CHUNKS) * bs * item + CHUNK_PAD[item])
    return -(-(b + (bs * m * item if x_staged else 0)) // 128) * 128


def batched_route(nb: int, bs: int, m: int, dtype: torch.dtype,
                  aligned: bool = True) -> str:
    """The batched kernel's route for ``(nb, bs, bs)`` blocks and an ``(nb
    * bs, m)`` block of ``dtype``; ``aligned`` says that the blocks, X and
    Y start on 16 bytes.

    * ``"bulk"``: a row of B_g is a multiple of 16 bytes (the bulk copies'
      unit), ``bs >= 32``, and two stages of B_g (in 8 chunks, each
      padded by 32 bytes in fp64, 16 in fp32) and X_g fit the 224 KB
      ring; the main path's shape, ``bs = 64, m = 8``, in fp64 and fp32;
    * ``"bulk_x_direct"``: the same, but X_g is too large for two stages
      with it (fp64 at ``bs = 64`` past ``m = 159``): B_g alone goes
      through the ring;
    * ``"rows"``: everything else (rows of 3 doubles or 5 floats, ``bs <
      32``, B_g past the ring: fp64 past ``bs = 118``, fp32 past ``bs =
      168``; unaligned pointers).

    The route is a choice by shape, not a fallback: the kernel refuses a
    route its operands do not meet, and the wrapper raises."""
    del nb                      # any nb >= 1 takes any route
    item = torch.empty((), dtype=dtype).element_size()
    if not aligned or (bs * item) % 16 or bs < MIN_BULK_ROWS:
        return "rows"
    for route, x_staged in (("bulk", True), ("bulk_x_direct", False)):
        if RING_BYTES // _stage_bytes(bs, m, item, x_staged) >= 2:
            return route
    return "rows"


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
    m = x.shape[1]
    y = torch.empty_like(x)
    ptrs = (inv_blocks.data_ptr(), x.data_ptr(), y.data_ptr())
    route = batched_route(nb, bs, m, x.dtype,
                          aligned=all(p % 16 == 0 for p in ptrs))
    lib = _build.library()
    fn = lib.repro_block_jacobi_apply_batched_f64 \
        if x.dtype == torch.float64 \
        else lib.repro_block_jacobi_apply_batched_f32
    _build.launch(NAME_BATCHED, fn, *ptrs, nb, bs, m, ROUTES.index(route),
                  _stream(x))
    return y
