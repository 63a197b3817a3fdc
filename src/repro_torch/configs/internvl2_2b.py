"""internvl2-2b [vlm] — InternViT frontend (stub) + InternLM2 backbone.
[arXiv:2404.16821; hf].  24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553.  The ViT provides 256 precomputed patch embeddings per image
(input_specs supplies them; only the projection is learned here)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=8,
    d_ff=8192,
    vocab=92553,
    vis_tokens=256,
    rules="tp",
)
