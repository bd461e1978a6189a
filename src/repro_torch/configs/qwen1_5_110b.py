"""qwen1.5-110b [dense] — GQA kv=8, QKV bias.  [hf:Qwen/Qwen1.5-*]"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256, remat="none")
