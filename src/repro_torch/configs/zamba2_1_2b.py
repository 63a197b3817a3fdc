"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].  38L d_model=2048, shared block: 32H (kv=32)
d_ff=8192; ssm_state=64.  The shared transformer block is applied every 6
mamba layers over [hidden ‖ embeddings] (2d → d in-proj)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    shared_attn_every=6,
    rules="tp",
)
