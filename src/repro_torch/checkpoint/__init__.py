from repro_torch.checkpoint.manager import (
    CheckpointManager,
    checkpoint_extra,
    latest_step,
    restore,
)

__all__ = ["CheckpointManager", "checkpoint_extra", "latest_step", "restore"]
