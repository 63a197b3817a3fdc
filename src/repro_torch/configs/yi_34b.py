"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652; hf].
60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_ff=20480,
    vocab=64000,
    rope_theta=10000.0,
    rules="fsdp_tp",
    remat="dots",
)
