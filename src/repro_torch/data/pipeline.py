"""Deterministic, resumable synthetic data pipeline (a copy of
``src/repro/data/pipeline.py``: numpy only, so both packages draw the same
tokens bit for bit).

  * per-host deterministic sharding: host h of H draws disjoint index
    ranges (seed, step, host) → identical global batch under any host
    count that divides the batch;
  * resumable: iterators are constructed at (step) and reproduce the exact
    batch sequence after restart, which the trainer's auto-resume relies on.

Batches are dicts of numpy arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    host: int = 0
    n_hosts: int = 1
    family: str = "dense"
    d_model: int = 0
    enc_frames: int = 0
    vis_tokens: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host])
    )


def synthetic_batches(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    """Zipfian token stream (matches real-text frequency skew — also what
    makes EmbedElim effective)."""
    local_b = cfg.batch // cfg.n_hosts
    step = start_step
    while True:
        rng = _batch_rng(cfg, step)
        toks = rng.zipf(1.3, size=(local_b, cfg.seq)).astype(np.int64)
        toks = np.minimum(toks - 1, cfg.vocab - 1).astype(np.int32)
        batch = {"tokens": toks}
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (local_b, cfg.enc_frames, cfg.d_model)
            ).astype(np.float32)
        if cfg.family == "vlm":
            batch["vis_embeds"] = rng.standard_normal(
                (local_b, cfg.vis_tokens, cfg.d_model)
            ).astype(np.float32)
        yield batch
        step += 1


def make_data_iter(model_cfg, batch: int, seq: int, *, seed=0, start_step=0):
    cfg = DataConfig(
        vocab=model_cfg.vocab,
        batch=batch,
        seq=seq,
        seed=seed,
        family=model_cfg.family,
        d_model=model_cfg.d_model,
        enc_frames=model_cfg.enc_frames,
        vis_tokens=model_cfg.vis_tokens,
    )
    return synthetic_batches(cfg, start_step)
