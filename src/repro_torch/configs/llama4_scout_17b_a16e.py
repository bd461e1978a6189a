"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    moe_experts=16, moe_top_k=1, moe_shared_experts=1,
    moe_groups=256, moe_capacity_factor=1.25,
    rope_theta=500_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=64, vocab_size=256, moe_experts=4,
                          moe_top_k=1, moe_groups=1, remat="none")
