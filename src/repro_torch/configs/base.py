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
``NotImplementedError`` naming its slice: none is left.  The dry-run
tooling of the JAX package's ``base`` (``input_specs``, ``SHAPES``, the
applicability table) waits for the port of ``launch/``.
"""
from __future__ import annotations

import importlib

from repro_torch.models import ModelConfig

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
