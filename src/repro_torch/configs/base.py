"""Architecture registry (PyTorch port of ``repro.configs.base``).

``get_config(arch)`` returns the assigned full-size config and
``smoke_config(arch)`` a reduced one of the same family for CPU tests, for
the four dense architectures and the MoE one (llama4-scout), whose files
carry over from the JAX package as they are.  The other five ids raise
``NotImplementedError`` and name the slice of the port that brings them.  The dry-run tooling of the JAX
package's ``base`` (``input_specs``, ``SHAPES``, the applicability table)
waits for the port of ``launch/``.
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
LATER = {
    "deepseek-v3-671b": "the MLA slice (MoE with multi-head latent "
                        "attention)",
    "zamba2-1.2b": "the hybrid slice",
    "xlstm-350m": "the SSM slice",
    "whisper-tiny": "the audio slice",
    "qwen2-vl-72b": "the VLM slice",
}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; expected one of "
                         f"{ARCH_IDS}")
    if arch in LATER:
        raise NotImplementedError(
            f"{arch} waits for {LATER[arch]} of the PyTorch port; the port "
            "runs the dense and MoE families so far")
    mod = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


ARCHS = ARCH_IDS  # alias
