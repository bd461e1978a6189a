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
(``src/repro_torch/csrc/grouped_mm_sm90.cu`` and ``grouped_mm.cu`` say
what bounds each route and how).

On the card it has two routes, chosen by :func:`route` from the dtype
alone (never from the offsets, so one CUDA graph serves every routing):

* ``"wgmma"``: bf16, ``csrc/grouped_mm_sm90.cu``, ``wgmma`` fed by a TMA
  ring, 128 x 256 tiles, or 192 x 192 once a group averages
  ``WIDE_TILE_ROWS_PER_GROUP`` rows (:func:`wgmma_tile`, from R and E);
  K and N multiples of 8 (16-byte rows);
* ``"mma"``: float32 and float64, ``csrc/grouped_mm.cu``, ``mma.sync``
  on the tensor cores fed by a four-stage ``cp.async`` ring: f32 as
  3xTF32 (each operand split into TF32 hi + lo, three products, each
  stage's sums joined to the running f32 sum by one rounded add, since the
  tensor cores truncate theirs), f64 on the fp64 tensor cores; 64 x 128
  tiles, or 144 x 128 once a group averages ``TALL_TILE_ROWS_PER_GROUP``
  rows (:func:`mma_tile`, from R and E); 16-byte copies when K and N allow
  them (:func:`mma_vec`), else element copies, so any K and N.

Every route holds at most ``MAX_TILES`` row tiles (about 8 M rows on
the 128- and 144-row tiles).
:func:`plain` is the plain version, a loop over the groups that reads the
offsets to the host, the CPU path and the card's oracle.
Both require ``offsets[0] == 0``, ``offsets[E] == R`` and non-decreasing
offsets; the kernels cannot check them without a host read and trust
them, the plain version checks.  Call it through
:func:`repro_torch.kernels.ops.grouped_mm`, which checks the operands and
dispatches by device.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

NAME = "grouped_mm"
#: K and N must be multiples of this on the bf16 route (16-byte rows)
ALIGN = 8
ROUTES = ("wgmma", "mma")
#: the wgmma route's tiles, rows x columns: the launcher's index
WGMMA_TILES = {"128x256": 0, "192x192": 1}
#: the wgmma route takes its 192 x 192 tile from this many rows a group,
#: its 128 x 256 tile below (an A/B on an H100, csrc/grouped_mm_sm90.cu)
WIDE_TILE_ROWS_PER_GROUP = 64
#: the mma route's tiles, rows x columns: the launcher's index
MMA_TILES = {"64x128": 0, "144x128": 1}
#: the mma route takes its 144 x 128 tile from this many rows a group, its
#: 64 x 128 tile below (an A/B on an H100: 64 x 128 led at 32 rows a group,
#: 144 x 128 at 64 and up; csrc/grouped_mm.cu, PERF.md row 12b)
TALL_TILE_ROWS_PER_GROUP = 64
#: the most row tiles a grid holds (its y extent): at most
#: ceil(R / tile_rows(route(dtype), R, E)) + min(E, R)
MAX_TILES = 65535
#: launches of each route since the last :func:`reset_route_launches`
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def route(dtype) -> str:
    """The route of a grouped product in ``dtype`` on the card: ``"wgmma"``
    for bf16, ``"mma"`` for f32 and f64; any other dtype raises.  The
    dtype alone: never the offsets."""
    if dtype in (torch.float32, torch.float64):
        return "mma"
    if dtype != torch.bfloat16:
        raise TypeError(f"grouped_mm: the kernels take bfloat16, float32 or "
                        f"float64, got {dtype}")
    return "wgmma"


def wgmma_tile(R: int, E: int) -> str:
    """The wgmma route's tile for R rows over E groups: 192 x 192 once the
    groups average ``WIDE_TILE_ROWS_PER_GROUP`` rows (a tile then holds
    most groups whole), else 128 x 256."""
    return "192x192" if R >= WIDE_TILE_ROWS_PER_GROUP * E else "128x256"


def mma_tile(R: int, E: int) -> str:
    """The mma route's tile for R rows over E groups: 144 x 128 once the
    groups average ``TALL_TILE_ROWS_PER_GROUP`` rows (a tile then holds
    nearly every group whole, so each weight slab is read about once),
    else 64 x 128 (the launch streams the hit experts' weights)."""
    return "144x128" if R >= TALL_TILE_ROWS_PER_GROUP * E else "64x128"


def mma_vec(dtype, K: int, N: int) -> bool:
    """Whether the mma route copies 16 bytes at a time for K and N in
    ``dtype`` (both multiples of 16 bytes' elements: 4 in f32, 2 in f64;
    the pointers must be 16-byte aligned too), else element by element."""
    per = 128 // torch.finfo(dtype).bits
    return K % per == 0 and N % per == 0


def tile_rows(name: str, R: int, E: int) -> int:
    """Rows of the tiles route ``name`` takes for R rows over E groups."""
    tile = wgmma_tile(R, E) if name == "wgmma" else mma_tile(R, E)
    return int(tile.split("x")[0])


def reset_route_launches() -> None:
    for name in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[name] = 0


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


def grouped_mm_cuda(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                    tile: Optional[str] = None) -> torch.Tensor:
    """Launch the dtype's route on checked CUDA operands (``tile`` None:
    :func:`wgmma_tile`'s or :func:`mma_tile`'s; the A/B of
    ``tools/grouped_ab.py`` and the card's checks name one); the mma route
    copies 16 bytes at a time where :func:`mma_vec` and the pointers allow,
    else element by element; returns a fresh ``(R, N)`` tensor."""
    R, K = x.shape
    E, _, N = w.shape
    name = route(x.dtype)
    y = torch.empty((R, N), dtype=x.dtype, device=x.device)
    lib = _build.library()
    args = (x.data_ptr(), w.data_ptr(), offsets.data_ptr(), y.data_ptr(), R,
            K, N, E)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name == "wgmma":
        _build.launch(NAME, lib.repro_grouped_wgmma_bf16, *args,
                      WGMMA_TILES[tile or wgmma_tile(R, E)], stream)
    else:
        vec = mma_vec(x.dtype, K, N) and all(
            t.data_ptr() % 16 == 0 for t in (x, w, y))
        suffix = {torch.float32: "f32", torch.float64: "f64"}[x.dtype]
        _build.launch(NAME, getattr(lib, f"repro_grouped_mm_{suffix}"),
                      *args, MMA_TILES[tile or mma_tile(R, E)], int(vec),
                      stream)
    ROUTE_LAUNCHES[name] += 1
    return y
