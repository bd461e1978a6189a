"""The LM stack of the port (PyTorch port of ``repro.models``): the dense
decoder family, prefill and cached decode, with the CUDA flash-attention
kernel under ``cfg.use_flash_kernel``, and the training loss."""
from .common import ModelConfig
from .transformer import (Transformer, decode_step, forward, init_cache,
                          init_params, loss_fn, prefill_step)

__all__ = ["ModelConfig", "Transformer", "decode_step", "forward",
           "init_cache", "init_params", "loss_fn", "prefill_step"]
