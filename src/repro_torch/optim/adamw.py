"""Functional AdamW with optional 8-bit moment states (PyTorch port of
``repro.optim.adamw``).

Parameters, gradients and moments are mappings of tensors keyed by the
parameter's name (``dict(model.named_parameters())``), so a moment lives
beside its parameter on its device.  ``state_dtype="i8"`` swaps both
moments to blockwise int8 (:mod:`.eightbit`), ``"bf16"`` stores them in
bfloat16; the update itself runs in f32 and is cast back, as in the JAX
package.  :func:`adamw_update` returns new tensors and writes none of its
inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from .eightbit import Q8, dequantize, quantize, zeros_like_q8

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "f32"       # f32 | bf16 | i8
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to
    ``min_lr_ratio * lr`` at ``decay_steps``; f32, on ``step``'s device."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    mult = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, mult)


def _zeros_state(p: torch.Tensor, cfg: AdamWConfig):
    if cfg.state_dtype == "i8":
        return zeros_like_q8(p)
    if cfg.state_dtype not in ("f32", "bf16"):
        raise ValueError(f"state_dtype must be f32 | bf16 | i8, not "
                         f"{cfg.state_dtype!r}")
    dt = torch.bfloat16 if cfg.state_dtype == "bf16" else torch.float32
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def adamw_init(params: Tensors, cfg: AdamWConfig) -> Dict:
    """``{"m": {name: moment}, "v": {...}, "count": 0-d int32}``."""
    device = next(iter(params.values())).device
    return {
        "m": {k: _zeros_state(p, cfg) for k, p in params.items()},
        "v": {k: _zeros_state(p, cfg) for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _load(s):
    return dequantize(s) if isinstance(s, Q8) else s.float()


def _store(x: torch.Tensor, like):
    if isinstance(like, Q8):
        return quantize(x)
    return x.to(like.dtype)


def adamw_update(params: Tensors, grads: Tensors, state: Mapping,
                 cfg: AdamWConfig, grad_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """One AdamW step.  ``grad_scale`` multiplies gradients (used by the
    pipelined clipper).  Returns ``(new_params, new_state)``."""
    count = state["count"] + 1
    lr = schedule(cfg, count)
    c1 = 1 - torch.pow(cfg.b1, count.float())
    c2 = 1 - torch.pow(cfg.b2, count.float())
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        if grad_scale is not None:
            g = g * grad_scale
        m, v = state["m"][k], state["v"][k]
        mf = _load(m) * cfg.b1 + (1 - cfg.b1) * g
        vf = _load(v) * cfg.b2 + (1 - cfg.b2) * g * g
        mhat = mf / c1
        vhat = vf / c2
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.detach().float()
        pf = pf - lr * (step + cfg.weight_decay * pf)
        new_p[k] = pf.to(p.dtype)
        new_m[k] = _store(mf, m)
        new_v[k] = _store(vf, v)
    return new_p, {"m": new_m, "v": new_v, "count": count.to(torch.int32)}
