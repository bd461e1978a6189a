"""The LM stack of the port (PyTorch port of ``repro.models``): the dense
and MoE decoder families (multi-head latent attention and its latent cache
included), the hybrid one (Mamba2 layers and a shared attention block,
``models/ssm.py``), the SSM one (xLSTM: sLSTM + mLSTM pairs,
``models/xlstm.py``), the audio one (whisper's encoder-decoder) and the
VLM (qwen2-vl: M-RoPE and patch embeddings), prefill and cached decode, with the CUDA
flash-attention kernel under ``cfg.use_flash_kernel`` and the
grouped-product kernel in the MoE sort dispatch, and the training loss
(with DeepSeek-V3's MTP)."""
from .common import ModelConfig
from .transformer import (Transformer, cache_logical_axes, decode_step,
                          forward, init_cache, init_params, loss_fn,
                          prefill_step)

__all__ = ["ModelConfig", "Transformer", "cache_logical_axes",
           "decode_step", "forward", "init_cache", "init_params", "loss_fn",
           "prefill_step"]
