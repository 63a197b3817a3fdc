"""qwen2-0.5b [dense] — GQA kv=2 with QKV bias [arXiv:2407.10671; hf].
24L d_model=896 14H d_ff=4864 vocab=151936, tied embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    rules="tp",
)
