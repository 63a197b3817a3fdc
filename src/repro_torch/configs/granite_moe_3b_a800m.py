"""granite-moe-3b-a800m [moe] — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].  32L d_model=1536 24H
(kv=8) expert d_ff=512 vocab=49155.  40 % 16 != 0 → TP-within-expert
sharding."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv=8,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    d_ff_expert=512,
    rules="tp",
)
