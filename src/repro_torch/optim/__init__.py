"""Optimizer of the port's training stack: AdamW and its schedules.  The
sparse EmbedElim update (``src/repro/optim/sparse.py``) is off the
trainer's path and not ported yet (ROADMAP.md queue A, item 8)."""
from repro_torch.optim.adamw import (
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
)
from repro_torch.optim.schedules import constant_lr, warmup_cosine

__all__ = [
    "OptState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "warmup_cosine",
    "constant_lr",
]
