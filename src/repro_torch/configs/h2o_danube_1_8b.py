"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window
attention [arXiv:2401.16818; hf].  24L d_model=2560 32H (kv=8) d_ff=6912
vocab=32000, window=4096 (mistral-style SWA) → runs long_500k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    d_ff=6912,
    vocab=32000,
    attn="swa",
    window=4096,
    rope_theta=10000.0,
    rules="tp",
)
