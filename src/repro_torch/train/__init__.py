from repro_torch.train.step import (
    TrainStepOut,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.train.trainer import SimulatedFailure, StragglerMonitor, Trainer, TrainerConfig

__all__ = [
    "SimulatedFailure",
    "StragglerMonitor",
    "TrainStepOut",
    "Trainer",
    "TrainerConfig",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
]
