"""The one traffic generator: a mix file (``traffic/<mix>.json``) and a
configuration file (``configs/<config>.json``) in, the rounds of lanes a
run drives out.  Every array comes from ``--seed`` alone, so the same seed
gives the same inputs whatever the program does with them.

Frozen copies of the program's own generators (``data/workloads.py``
``zipf_keys``; ``chip_smoke.py`` ``prefill`` and ``prefill_starts``): the
program may change, the yardstick may not.

A mix file holds:

``round_lanes``      lanes in a round (one client, closed loop: rounds are
                     issued back to back);
``ops``              op name -> share of the lanes; each round holds exactly
                     ``round(share * round_lanes)`` lanes of each op, in an
                     order drawn from the seed (the last op takes the rest);
``keys``             op name -> key law: ``{"dist": "zipf", "s": 1.0}`` over
                     key rank (key = rank, the hottest key is 0),
                     ``{"dist": "uniform"}``, or ``{"dist": "unloaded"}``:
                     keys never loaded, uniform over the range, each drawn
                     once (inserts of new records);
``range_records``    ``{"lo": 1, "hi": 100}``: a range lane asks for L ~
                     U[lo, hi] records, encoded as a key span of L times the
                     key range over the loaded keys;
``scan_cap``         rows a range lane may return;
``warmup_rounds``    rounds of the mix run in set-up.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np

# The round API's op codes (``key = lo, val = span`` on a range lane).
OP_NOP, OP_FIND, OP_INSERT, OP_DELETE, OP_RANGE = 0, 1, 2, 3, 4
OP_CODES = {"find": OP_FIND, "insert": OP_INSERT, "delete": OP_DELETE, "range": OP_RANGE}

# SeedSequence streams: one per use of the seed.
_LOAD, _ROUND, _UNLOADED = 1, 2, 3


class Round(NamedTuple):
    ops: np.ndarray  # (B,) int32
    keys: np.ndarray  # (B,) int64
    vals: np.ndarray  # (B,) int64 (span on range lanes)


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, *stream])


@functools.lru_cache(maxsize=4)
def zipf_cdf(key_range: int, s: float) -> np.ndarray:
    """Inverse-CDF table of bounded Zipf(s) over key rank [0, key_range)."""
    ranks = np.arange(1, key_range + 1, dtype=np.float64)
    w = 1.0 / np.power(ranks, s)
    return np.cumsum(w) / np.sum(w)


def zipf_keys(rng: np.random.Generator, n: int, key_range: int, s: float) -> np.ndarray:
    """Bounded Zipf(s) over [0, key_range) by inverse-CDF sampling."""
    return np.searchsorted(zipf_cdf(key_range, s), rng.random(n)).astype(np.int64)


def load_keys(seed: int, config: dict) -> np.ndarray:
    """The ``load_keys`` distinct keys of [0, key_range) that set-up loads,
    in load order."""
    rng = _rng(seed, _LOAD)
    return rng.choice(config["key_range"], size=config["load_keys"], replace=False).astype(np.int64)


def load_rounds(seed: int, config: dict) -> List[Round]:
    """Set-up's insert rounds: one of ``load_first_lanes`` into the empty
    tree, then rounds of ``load_lanes`` (a narrow first round seeds the
    leaves that the wide rounds then spread over)."""
    keys = load_keys(seed, config)
    rng = _rng(seed, _LOAD, 1)
    n = keys.size
    starts = [0] + list(range(config["load_first_lanes"], n, config["load_lanes"]))
    out = []
    for i, j in zip(starts, starts[1:] + [n]):
        chunk = keys[i:j]
        vals = rng.integers(0, config["value_range"], chunk.size).astype(np.int64)
        out.append(Round(np.full(chunk.size, OP_INSERT, np.int32), chunk, vals))
    return out


class Generator:
    """Round ``r`` of a mix, drawn from ``(seed, r)`` alone."""

    def __init__(self, seed: int, config: dict, mix: dict):
        self.seed = int(seed)
        self.config = config
        self.mix = mix
        lanes = int(mix["round_lanes"])
        names = list(mix["ops"])
        counts = [int(round(mix["ops"][n] * lanes)) for n in names[:-1]]
        counts.append(lanes - sum(counts))
        if min(counts) < 0:
            raise ValueError(f"mix {mix.get('name')}: op shares exceed one")
        self.lane_ops = np.repeat([OP_CODES[n] for n in names], counts).astype(np.int32)
        unloaded = [op for op, law in mix["keys"].items() if law["dist"] == "unloaded"]
        self._unloaded_per_round = sum(dict(zip(names, counts)).get(op, 0) for op in unloaded)
        if unloaded:
            free = np.ones(config["key_range"], bool)
            free[load_keys(seed, config)] = False
            self._unloaded = _rng(seed, _UNLOADED).permutation(np.nonzero(free)[0]).astype(np.int64)

    def _keys(self, rng, op: str, n: int, first: int) -> np.ndarray:
        """``n`` keys of ``op``'s law; an ``unloaded`` law takes the never-
        loaded keys ``first``, ``first + 1``, ... of the seed's order."""
        law = self.mix["keys"][op]
        kr = self.config["key_range"]
        if law["dist"] == "zipf":
            return zipf_keys(rng, n, kr, float(law["s"]))
        if law["dist"] == "uniform":
            return rng.integers(0, kr, n).astype(np.int64)
        if law["dist"] == "unloaded":
            return np.take(self._unloaded, np.arange(first, first + n), mode="wrap")
        raise ValueError(f"unknown key law {law['dist']!r}")

    def round(self, r: int) -> Round:
        rng = _rng(self.seed, _ROUND, r)
        lanes = self.lane_ops.size
        ops = self.lane_ops[rng.permutation(lanes)]
        keys = np.zeros(lanes, np.int64)
        vals = rng.integers(0, self.config["value_range"], lanes).astype(np.int64)
        first = r * self._unloaded_per_round
        for op, code in OP_CODES.items():
            lane = np.nonzero(ops == code)[0]
            if lane.size:
                keys[lane] = self._keys(rng, op, lane.size, first)
                if self.mix["keys"][op]["dist"] == "unloaded":
                    first += lane.size
        rl = np.nonzero(ops == OP_RANGE)[0]
        if rl.size:
            rr = self.mix["range_records"]
            records = rng.integers(rr["lo"], rr["hi"] + 1, rl.size).astype(np.int64)
            vals[rl] = records * self.span_per_record()
        return Round(ops, keys, vals)

    def span_per_record(self) -> int:
        """Key span of one record: the key range over the loaded keys."""
        return max(1, int(round(self.config["key_range"] / self.config["load_keys"])))

    def scan_cap(self) -> int:
        return int(self.mix.get("scan_cap", 128))
