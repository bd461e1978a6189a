"""qwen2.5-32b [dense] — GQA kv=8, QKV bias.  [hf:Qwen/Qwen2.5-*]"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256, remat="none")
