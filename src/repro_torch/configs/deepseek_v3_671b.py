"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437]"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab_size=129280,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    moe_experts=256, moe_top_k=8, moe_shared_experts=1,
    moe_groups=256, moe_capacity_factor=1.25,
    # DeepSeek-V3 "does not drop any tokens during training or inference"
    # (arXiv:2412.19437 §3): the dropless sort dispatch, whose expert
    # products are the grouped kernel (kernels/grouped_mm.py)
    moe_impl="sort",
    use_mtp=True, mtp_loss_weight=0.3,
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab_size=256, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        moe_experts=4, moe_top_k=2, moe_groups=1, remat="none")
