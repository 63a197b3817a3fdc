"""Meta-tensor stand-ins for every model input (port of
``src/repro/launch/inputs.py``, which builds ``ShapeDtypeStruct`` s): the
shapes and dtypes of a cell's step arguments, with no storage (the
dry-run's inputs)."""
from __future__ import annotations

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import TensorSpec


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _cache(spec):
    if spec is None:
        return None
    if isinstance(spec, TensorSpec):
        return _meta(spec.shape, spec.dtype)
    if isinstance(spec, dict):
        return {k: _cache(v) for k, v in spec.items()}
    return type(spec)(*(_cache(s) for s in spec))


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The step's inputs of an (arch × shape) cell: a train / prefill
    batch, or a decode step's ``tokens``, ``pos`` and ``cache``."""
    b, s = shape.batch, shape.seq
    dt = getattr(torch, cfg.dtype)
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((b, s), torch.int32)}
        if cfg.family == "audio":
            batch["frames"] = _meta((b, cfg.enc_frames, cfg.d_model), dt)
        if cfg.family == "vlm":
            batch["vis_embeds"] = _meta((b, cfg.vis_tokens, cfg.d_model), dt)
        return batch
    # decode: one new token against a cache of length s
    return {
        "tokens": _meta((b,), torch.int32),
        "pos": _meta((), torch.int32),
        "cache": _cache(backbone.cache_spec(cfg, b, s)),
    }
