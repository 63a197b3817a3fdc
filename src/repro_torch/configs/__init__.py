"""Architecture registry of the port: every arch of the JAX package's
registry (the decoder-only LMs, dense, MoE with MLA, VLM; the ssm, hybrid
and audio families), in its order, and the assigned input shapes.

40 cells = 10 archs × 4 shapes.  ``long_500k`` requires sub-quadratic
sequence mixing and is skipped for pure full-attention archs (recorded by
``cell_status``, not dropped), as in the JAX package."""
from __future__ import annotations

import importlib
from typing import Dict, NamedTuple

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


class ShapeSpec(NamedTuple):
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_status(cfg: ModelConfig, shape: ShapeSpec) -> str:
    """'run' or a skip reason for an (arch × shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "skip: pure full-attention arch (long_500k needs sub-quadratic)"
    return "run"


def all_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            yield arch, cfg, shape, cell_status(cfg, shape)
