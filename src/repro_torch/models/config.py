"""Model configuration shared by all architectures (a copy of
``src/repro/models/config.py``: plain dataclasses, no JAX)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 → d_model // n_heads

    # attention
    attn: str = "full"  # full | swa | mla
    window: int = 0  # sliding-window size (swa)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True

    # MLA (deepseek-v3)
    q_lora: int = 0
    kv_lora: int = 0
    rope_head: int = 0  # decoupled rope head dim
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 0  # 0 = global dispatch; >0 = shard-local groups

    # SSM / hybrid
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    slstm_every: int = 0  # xlstm: every k-th block is an sLSTM block
    mlstm_chunk: int = 0  # 0 = sequential scan (paper form); >0 = chunkwise
    shared_attn_every: int = 0  # zamba2: shared attn block cadence

    # enc-dec (whisper)
    enc_layers: int = 0
    enc_frames: int = 0

    # vlm
    vis_tokens: int = 0

    # misc
    norm: str = "rms"  # rms | ln
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False

    # execution policy
    dtype: str = "bfloat16"  # compute dtype
    remat: str = "none"  # none | full | dots
    use_pallas: bool = False
    rules: str = "tp"  # logical→physical sharding rule set
    scan_layers: bool = True

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k (sub-quadratic sequence mixing)?"""
        return self.family in ("ssm", "hybrid") or self.attn == "swa"

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper is enc-dec)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.family not in ("hybrid",) else 4),
        d_model=128,
        n_heads=4,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv < cfg.n_heads else 4,
        d_head=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        window=min(cfg.window, 64) if cfg.window else 0,
        q_lora=64 if cfg.q_lora else 0,
        kv_lora=32 if cfg.kv_lora else 0,
        rope_head=16 if cfg.rope_head else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        n_shared=cfg.n_shared,
        first_k_dense=min(cfg.first_k_dense, 1),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        slstm_every=min(cfg.slstm_every, 2) if cfg.slstm_every else 0,
        shared_attn_every=min(cfg.shared_attn_every, 2) if cfg.shared_attn_every else 0,
        enc_layers=min(cfg.enc_layers, 2),
        enc_frames=min(cfg.enc_frames, 32),
        vis_tokens=min(cfg.vis_tokens, 8),
        dtype="float32",
        scan_layers=cfg.scan_layers,
    )
    base.update(overrides)
    return cfg.replace(**base)
