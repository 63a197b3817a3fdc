"""Architecture registry of the port.

Only the archs whose family the port runs are here: the dense decoder-only
LMs (``family="dense"``).  Any other arch of the JAX package's registry
raises ``NotImplementedError`` naming the roadmap item that ports its
family."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "yi-9b": "yi_9b",
    "yi-34b": "yi_34b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
}
_NOT_PORTED = (
    "internvl2-2b", "xlstm-350m", "granite-moe-3b-a800m", "deepseek-v3-671b",
    "whisper-tiny", "zamba2-1.2b",
)

ARCH_IDS = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch}: its family is not ported yet (ROADMAP.md queue A, item 6: "
            "the moe, vlm, ssm, hybrid and audio families)"
        )
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
