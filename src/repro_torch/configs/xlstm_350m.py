"""xlstm-350m [ssm] — alternating sLSTM + mLSTM blocks.  [arXiv:2405.04517]"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                          vocab_size=256, remat="none")
