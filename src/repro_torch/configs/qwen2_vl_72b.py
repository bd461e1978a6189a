"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution (patch frontend stubbed:
the prefill takes patch embeddings, ``batch["patch_embeds"]``, spliced in
at row 1, and 3-D (t, h, w) positions, ``batch["positions"]``).
[arXiv:2409.12191]"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0, frontend_stub=True,
)


def smoke() -> ModelConfig:
    # sections sum to hd/2 (= 8 for hd 16)
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256,
                          mrope_sections=(2, 3, 3), remat="none")
