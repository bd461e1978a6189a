"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block every 6
layers; sliding-window attention for long contexts.  [arXiv:2411.15242]"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2,
    hybrid_shared_period=6, sliding_window=4096,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=256, ssm_state=16,
                          hybrid_shared_period=2, sliding_window=64,
                          remat="none")
