"""Dictionary-operation workload generators (numpy copy of
``src/repro/data/workloads.py``): uniform / Zipfian key streams × update
fraction, plus the YCSB-E scan-heavy mix, the split-path baseline of a
mixed round and the paper's prefill."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.elimination import OP_DELETE, OP_FIND, OP_INSERT, OP_NOP, OP_RANGE


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


def split_scan_round(ops: np.ndarray, keys: np.ndarray, vals: np.ndarray):
    """Split one mixed round into its scan half and its point-op half: the
    split-path baseline for A/B benchmarks, which runs every batch as two
    rounds (the engine itself runs mixed batches fused, scans linearized
    before the round's writes).

    Returns ``((lo, hi), (ops', keys', vals'))``: OP_RANGE rows become
    ``[lo, lo + span)`` scan intervals (for ``scan_round``); in the point-op
    arrays they are masked to OP_NOP, so each op keeps its result position
    in ``apply_round``."""
    ops = np.asarray(ops)
    keys = np.asarray(keys)
    vals = np.asarray(vals)
    is_scan = ops == OP_RANGE
    lo = keys[is_scan]
    hi = lo + np.maximum(vals[is_scan], 1)
    point_ops = np.where(is_scan, OP_NOP, ops).astype(np.int32)
    return (lo, hi), (point_ops, keys, np.where(is_scan, 0, vals))


def prefill_tree(tree, cfg: WorkloadConfig, target_frac: float = 0.5):
    """Prefill to the expected steady-state size (paper methodology):
    ``target_frac`` of the key range, distinct keys from ``cfg.seed + 999``
    with values equal to the keys, in insert rounds of 1,024 lanes through
    ``tree.apply_round`` (an ``ABTree`` in either mode, an ``ABForest``, a
    ``DurableABTree`` or a ``DurableForest``'s ``forest``)."""
    rng = np.random.default_rng(cfg.seed + 999)
    n = int(cfg.key_range * target_frac)
    keys = rng.choice(cfg.key_range, size=n, replace=False).astype(np.int64)
    bs = 1024
    for i in range(0, n, bs):
        chunk = keys[i : i + bs]
        tree.apply_round(np.full(chunk.size, OP_INSERT, np.int32), chunk, chunk)
    return tree
