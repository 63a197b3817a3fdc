"""Optimizer of the port's training stack: AdamW, its schedules and the
sparse EmbedElim update."""
from repro_torch.optim.adamw import (
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
)
from repro_torch.optim.schedules import constant_lr, warmup_cosine
from repro_torch.optim.sparse import embed_elim_update

__all__ = [
    "OptState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "warmup_cosine",
    "constant_lr",
    "embed_elim_update",
]
