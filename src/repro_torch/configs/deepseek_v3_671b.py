"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8
[arXiv:2412.19437; hf].  61L d_model=7168 128H kv=128 (MLA: q_lora=1536,
kv_lora=512, rope_head=64), expert d_ff=2048, first 3 layers dense
(d_ff=18432), vocab=129280.  256 % 16 == 0 → expert parallelism over the
model axis + FSDP-style param sharding (rules='ep_fsdp').  MTP head
omitted."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv=128,
    d_head=128,
    d_ff=18432,
    vocab=129280,
    attn="mla",
    q_lora=1536,
    kv_lora=512,
    rope_head=64,
    n_experts=256,
    top_k=8,
    d_ff_expert=2048,
    n_shared=1,
    first_k_dense=3,
    rules="ep_fsdp",
    remat="dots",
)
