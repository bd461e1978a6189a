"""whisper-tiny [audio] — enc-dec, conv frontend stubbed (the prefill takes
post-conv frame embeddings, ``batch["frames"]``).  [arXiv:2212.04356]

The decoder's learned position table has 32,768 rows (the JAX package
sizes it for its decode_32k dry-run cell; whisper's own convention is
448).
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, n_encoder_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    is_encoder_decoder=True, frontend_stub=True, tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=2, n_encoder_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                          remat="none")
