"""Architecture registry (PyTorch port of ``repro.configs.base``).

``get_config(arch)`` returns the assigned full-size config and
``smoke_config(arch)`` a reduced one of the same family for CPU tests, for
the four dense architectures, the two MoE ones (llama4-scout, and
deepseek-v3 with multi-head latent attention), the hybrid zamba2-1.2b
(Mamba2 layers and one shared attention block), the SSM xlstm-350m
(sLSTM + mLSTM pairs), the audio whisper-tiny (an encoder over frame
embeddings and a decoder with cross-attention) and the VLM qwen2-vl-72b
(M-RoPE, patch embeddings spliced into the prompt), whose files carry
over from the JAX package as they are.  ``LATER`` names the
architectures of later slices of the port, each of which raises
``NotImplementedError`` naming its slice: none is left.

The dry run's grid (:mod:`repro_torch.launch.dryrun`): ``SHAPES``, the
JAX package's four input shapes; ``skip_reason`` / ``applicable``, its
applicability table, word for word; ``input_specs(cfg, shape)``, every
input of the step function a shape exercises (train / prefill / decode)
as a tensor on the ``meta`` device, where the JAX package gives
``ShapeDtypeStruct``s: shapes and dtypes, no memory.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional

import torch

from repro_torch.models import ModelConfig, init_cache

ARCH_IDS = [
    "phi3-mini-3.8b", "qwen2.5-32b", "qwen3-8b", "qwen1.5-110b",
    "deepseek-v3-671b", "llama4-scout-17b-a16e", "zamba2-1.2b",
    "xlstm-350m", "whisper-tiny", "qwen2-vl-72b",
]

#: the architectures of later slices, and the slice that brings each
LATER: dict = {}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; expected one of "
                         f"{ARCH_IDS}")
    if arch in LATER:
        raise NotImplementedError(
            f"{arch} waits for {LATER[arch]} of the PyTorch port")
    mod = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


ARCHS = ARCH_IDS  # alias


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str       # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

_FULL_ATTN = {"phi3-mini-3.8b", "qwen2.5-32b", "qwen3-8b", "qwen1.5-110b",
              "deepseek-v3-671b", "llama4-scout-17b-a16e", "qwen2-vl-72b",
              "whisper-tiny"}


def skip_reason(arch: str, shape: str) -> Optional[str]:
    """Why the cell (arch, shape) is not run, or ``None``: the JAX
    package's table and strings."""
    if shape == "long_500k" and arch in _FULL_ATTN:
        return ("full-attention backbone: 500k-token KV decode is "
                "quadratic-prefill/huge-KV; run only for SSM/hybrid archs "
                "(DESIGN.md §4)")
    return None


def applicable(arch: str, shape: str) -> bool:
    return skip_reason(arch, shape) is None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape, arch: str = "") -> Dict[str, Any]:
    """``meta`` tensors for the inputs of the step function of ``shape``
    (a name of :data:`SHAPES` or a :class:`ShapeSpec`):

    train:   ``{"batch": {tokens[, frames, patch_embeds, positions]}}``
    prefill: ``{"batch": {...}}``                      (no labels)
    decode:  ``{"tokens": (B, 1), "cache": <init_cache on meta>,
    "cache_len": 0-d}``, whisper's cross cache of 1,500 frames.
    """
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = sp.global_batch, sp.seq_len
    if sp.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
        if cfg.family == "audio":
            # frontend stub: precomputed post-conv frame embeddings
            batch["frames"] = _meta((B, S, cfg.d_model), cfg.dtype)
        if cfg.family == "vlm":
            n_patch = min(1024, S - 2)
            batch["patch_embeds"] = _meta((B, n_patch, cfg.d_model),
                                          cfg.dtype)
            batch["positions"] = _meta((B, S, 3), torch.int32)
        return {"batch": batch}
    # decode: one new token against a seq_len cache
    cache = init_cache(cfg, B, S, device="meta",
                       enc_len=1500 if cfg.family == "audio" else 0)
    return {"tokens": _meta((B, 1), torch.int32), "cache": cache,
            "cache_len": _meta((), torch.int32)}
