"""Feed-forward blocks (PyTorch port of the dense part of
``repro.models.moe``): the SwiGLU MLP of the dense family.  The expert
routing waits for the MoE slice of the port."""
from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init


def dense_ffn_init(generator: torch.Generator, cfg: ModelConfig,
                   d_ff: int = 0) -> Dict[str, torch.Tensor]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": dense_init(generator, (d, ff), cfg.param_dtype),
        "wg": dense_init(generator, (d, ff), cfg.param_dtype),
        "wo": dense_init(generator, (ff, d), cfg.param_dtype),
    }


def dense_ffn(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: ``(silu(x @ wg) * (x @ wi)) @ wo``."""
    h = x @ p["wi"].to(x.dtype)
    g = x @ p["wg"].to(x.dtype)
    return (F.silu(g) * h) @ p["wo"].to(x.dtype)
