"""Pipelined gradient-norm clipping (PyTorch port of
``repro.optim.clipping``): step k is clipped with step k-1's global norm,
so this step's norm has no consumer inside the step (the paper's
dependency-breaking idea applied to training).  The first step, with no
earlier norm, uses its own."""
from __future__ import annotations

from typing import Iterable, Mapping, NamedTuple, Tuple, Union

import torch


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
    leaves = grads.values() if isinstance(grads, Mapping) else grads
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


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
