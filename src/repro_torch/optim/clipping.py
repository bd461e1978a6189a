"""Pipelined gradient-norm clipping (PyTorch port of
``repro.optim.clipping``): step k is clipped with step k-1's global norm,
so this step's norm has no consumer inside the step (the paper's
dependency-breaking idea applied to training).  The first step, with no
earlier norm, uses its own.  On a device mesh (DTensor gradients) the
norm is one all-reduce across the mesh's ranks."""
from __future__ import annotations

from typing import Iterable, Mapping, NamedTuple, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import mesh_group


class PipelinedClipState(NamedTuple):
    prev_norm: torch.Tensor   # global grad norm from the previous step
    initialized: torch.Tensor


def pipelined_clip_init(device=None) -> PipelinedClipState:
    return PipelinedClipState(
        torch.ones((), dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.bool, device=device))


def global_norm(grads: Union[Mapping[str, torch.Tensor],
                             Iterable[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of every gradient's sum of squares, in f32."""
    leaves = list(grads.values() if isinstance(grads, Mapping) else grads)
    if leaves and isinstance(leaves[0], DTensor):
        return _mesh_norm(leaves)
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


def _mesh_norm(leaves) -> torch.Tensor:
    """The global norm of DTensor gradients (sharded or replicated, not
    partial) as a plain 0-d tensor, the same on every rank: each rank sums
    the squares of its shards, a shard replicated over a mesh dimension
    counted by that dimension's first rank only, and one all-reduce adds
    the ranks' sums."""
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].to_local().device)
    for g in leaves:
        if any(p.is_partial() for p in g.placements):
            raise ValueError("global_norm takes reduced gradients, not "
                             f"partial sums ({g.placements})")
        if all(c == 0 for c, p in zip(coord, g.placements)
               if not p.is_shard()):
            total = total + torch.sum(torch.square(g.to_local().float()))
    dist.all_reduce(total, group=mesh_group(mesh))
    return torch.sqrt(total)


def pipelined_clip(grads, state: PipelinedClipState, max_norm: float
                   ) -> Tuple[torch.Tensor, PipelinedClipState]:
    """Returns ``(grad_scale, new_state)``: the scale from
    ``state.prev_norm`` (stale by one step), the fresh norm in the new
    state for the next step."""
    fresh = global_norm(grads)
    eff = torch.where(state.initialized, state.prev_norm, fresh)
    scale = torch.clamp(max_norm / torch.clamp(eff, min=1e-9), max=1.0)
    return scale, PipelinedClipState(fresh, torch.ones_like(
        state.initialized))
