"""Architecture registry of the port: every arch of the JAX package's
registry (the decoder-only LMs, dense, MoE with MLA, VLM; the ssm, hybrid
and audio families), in its order."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "internvl2-2b": "internvl2_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "yi-9b": "yi_9b",
    "yi-34b": "yi_34b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "xlstm-350m": "xlstm_350m",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "whisper-tiny": "whisper_tiny",
    "zamba2-1.2b": "zamba2_1_2b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
