"""Blockwise 8-bit state quantization (Dettmers-style) for optimizer
moments (PyTorch port of ``repro.optim.eightbit``): Adam m/v in int8 with
fp32 per-block scales, about 2.06 bytes a parameter instead of 8.

Blocks run along the LAST dim (128 wide where it divides, else the whole
dim), so a stacked ``(L, ...)`` leaf's codes and scales are its layers'
stacked: a layer's :class:`Q8` is the JAX package's slice of the stacked
one.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BLOCK = 128


class Q8(NamedTuple):
    codes: torch.Tensor    # int8, original shape
    scales: torch.Tensor   # fp32, (*shape[:-1], last_dim // bs)


def _blocksize(x_shape) -> int:
    if not x_shape:
        return 1
    last = x_shape[-1]
    return BLOCK if last % BLOCK == 0 else last


def quantize(x: torch.Tensor) -> Q8:
    if x.dim() == 0:
        return Q8(torch.clamp(torch.round(x), -127, 127).to(torch.int8),
                  torch.ones((), dtype=torch.float32, device=x.device))
    bs = _blocksize(x.shape)
    xb = x.float().reshape(*x.shape[:-1], x.shape[-1] // bs, bs)
    scale = xb.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    codes = torch.clamp(torch.round(xb / scale[..., None]), -127, 127
                        ).to(torch.int8)
    return Q8(codes.reshape(x.shape), scale)


def dequantize(q: Q8) -> torch.Tensor:
    if q.codes.dim() == 0:
        return q.codes.float() * q.scales
    bs = _blocksize(q.codes.shape)
    xb = q.codes.float().reshape(*q.codes.shape[:-1],
                                 q.codes.shape[-1] // bs, bs)
    return (xb * q.scales[..., None]).reshape(q.codes.shape)


def zeros_like_q8(x: torch.Tensor) -> Q8:
    if x.dim() == 0:
        return Q8(torch.zeros((), dtype=torch.int8, device=x.device),
                  torch.ones((), dtype=torch.float32, device=x.device))
    bs = _blocksize(x.shape)
    return Q8(torch.zeros(x.shape, dtype=torch.int8, device=x.device),
              torch.ones((*x.shape[:-1], x.shape[-1] // bs),
                         dtype=torch.float32, device=x.device))
