"""Architecture registry of the port.

The archs whose family the port runs are here: the decoder-only LMs, dense,
MoE (MLA included) and VLM.  Any other arch of the JAX package's registry
raises ``NotImplementedError`` naming the roadmap item that ports its
family."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "internvl2-2b": "internvl2_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "yi-9b": "yi_9b",
    "yi-34b": "yi_34b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-v3-671b": "deepseek_v3_671b",
}
_NOT_PORTED = ("xlstm-350m", "whisper-tiny", "zamba2-1.2b")

ARCH_IDS = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch}: its family is not ported yet (ROADMAP.md queue A, item 6: "
            "the ssm, hybrid and audio families)"
        )
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
