"""qwen3-8b [dense] — GQA kv=8, qk_norm.  [hf:Qwen/Qwen3-8B]"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab_size=151936,
    qk_norm=True, head_dim=128, rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256, head_dim=16,
                          remat="none")
