"""Dictionary-operation workload generators (numpy copy of
``src/repro/data/workloads.py``): uniform / Zipfian key streams × update
fraction, plus the YCSB-E scan-heavy mix."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.elimination import OP_DELETE, OP_FIND, OP_INSERT, OP_RANGE


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    key_range: int = 10_000
    update_frac: float = 1.0  # inserts+deletes fraction (rest = finds)
    dist: str = "uniform"  # uniform | zipf
    zipf_s: float = 1.0
    batch: int = 256
    seed: int = 0


@functools.lru_cache(maxsize=32)
def _zipf_cdf(key_range: int, s: float) -> np.ndarray:
    """Inverse-CDF table for bounded Zipf(s) over [0, key_range)."""
    ranks = np.arange(1, key_range + 1, dtype=np.float64)
    w = 1.0 / np.power(ranks, s)
    return np.cumsum(w) / np.sum(w)


def zipf_keys(rng: np.random.Generator, n: int, key_range: int, s: float):
    """Bounded Zipf(s) over [0, key_range) via inverse-CDF sampling."""
    return np.searchsorted(_zipf_cdf(key_range, s), rng.random(n)).astype(np.int64)


def _sample_keys(rng: np.random.Generator, cfg: WorkloadConfig) -> np.ndarray:
    if cfg.dist == "zipf":
        return zipf_keys(rng, cfg.batch, cfg.key_range, cfg.zipf_s)
    return rng.integers(0, cfg.key_range, cfg.batch).astype(np.int64)


def op_stream(cfg: WorkloadConfig, n_rounds: int):
    """Yields (ops, keys, vals) rounds."""
    rng = np.random.default_rng(cfg.seed)
    for _ in range(n_rounds):
        keys = _sample_keys(rng, cfg)
        u = rng.random(cfg.batch)
        ops = np.where(
            u < cfg.update_frac / 2,
            OP_INSERT,
            np.where(u < cfg.update_frac, OP_DELETE, OP_FIND),
        ).astype(np.int32)
        vals = rng.integers(0, 1 << 30, cfg.batch).astype(np.int64)
        yield ops, keys, vals


def ycsb_e_stream(
    cfg: WorkloadConfig,
    n_rounds: int,
    scan_frac: float = 0.95,
    max_span: int = 64,
):
    """YCSB Workload-E analog: ``scan_frac`` short range scans (start key
    from the configured distribution, span uniform in [1, max_span]), the
    rest inserts.  OP_RANGE rows encode lo = key, span = val, the round
    engine's lane encoding."""
    rng = np.random.default_rng(cfg.seed)
    for _ in range(n_rounds):
        keys = _sample_keys(rng, cfg)
        u = rng.random(cfg.batch)
        ops = np.where(u < scan_frac, OP_RANGE, OP_INSERT).astype(np.int32)
        spans = rng.integers(1, max_span + 1, cfg.batch).astype(np.int64)
        vals = np.where(
            ops == OP_RANGE, spans, rng.integers(0, 1 << 30, cfg.batch)
        ).astype(np.int64)
        yield ops, keys, vals
