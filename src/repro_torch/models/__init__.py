"""LM stack of the port: the decoder-only families (dense, moe, vlm)."""
from repro_torch.models.backbone import (
    cache_spec,
    compute_params,
    forward_decode,
    forward_train,
    init_cache,
    loss_fn,
    model_spec,
)
from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.params import count_params, init_params

__all__ = [
    "ModelConfig",
    "cache_spec",
    "compute_params",
    "count_params",
    "forward_decode",
    "forward_train",
    "init_cache",
    "init_params",
    "loss_fn",
    "model_spec",
    "reduced",
]
