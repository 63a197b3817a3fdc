"""Linearizability witness: replay a recorded audit history and verify it
(copy of ``src/repro/obs/witness.py`` over the port's ``DictOracle`` and
``Recorder``; host-side: it reads records, never tensors).

The flight recorder (``repro_torch.obs.recorder``) captures one record per round
in the engine's chosen linearization (arrival order per key; scans
linearized at round start).  This module replays those records through the
sequential ``DictOracle`` and verifies that every recorded per-lane result
— including the return values of elim-annihilated insert/delete pairs —
is exactly what a legal sequential history would have produced.  That
turns the paper's linearizability claim into a checked property of the
recorded history itself, not just of the test suite's synthetic rounds.

What is checked, per round record:

  * every point lane's ``results[i]`` / ``found[i]`` equals the oracle's
    §3 dictionary semantics applied in arrival order (insert returns the
    existing value on presence, delete returns the removed value, find
    the current value — NOTFOUND/absent otherwise);
  * every range lane's recorded rows equal the oracle's snapshot scan of
    ``[lo, lo+span)`` at round start, clipped to the recorded
    ``scan_cap`` (scans linearize before the round's writes);
  * elim notes are structurally consistent: a round's per-shard
    eliminated counts never exceed its update-lane count.

A history that fails any check is NOT a legal linearization of the
recorded operations — the checker raises :class:`WitnessError` (CLI exit
code 1).  The negative tests in ``tests/test_torch_witness.py`` corrupt a
valid history (swap an eliminated insert/delete pair's results, drop a
delete) and prove the checker rejects it.

The replay needs the history from its true start: a ring that dropped old
rounds cannot be replayed from an empty oracle.  ``check_history`` detects
this (first round record's ``seq`` preceded by evicted round records is
undetectable in general, so callers size the recorder's ring to the run).

CLI::

    python -m repro_torch.obs.witness audit.jsonl        # exit 0 iff valid
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Sequence

from repro_torch.core.abtree import NOTFOUND, OP_DELETE, OP_INSERT, OP_NOP, OP_RANGE
from repro_torch.core.oracle import DictOracle
from repro_torch.obs.recorder import Recorder

__all__ = ["WitnessError", "WitnessReport", "check_history", "check_file", "main"]

_NOTFOUND = int(NOTFOUND)


class WitnessError(AssertionError):
    """The recorded history is not a legal sequential history."""


class WitnessReport:
    """Outcome of a successful replay."""

    def __init__(self, rounds: int, lanes: int, eliminated: int, state: dict,
                 prefix_states=None):
        self.rounds = rounds  # round records replayed
        self.lanes = lanes  # non-NOP lanes verified
        self.eliminated = eliminated  # elim-annihilated update ops audited
        self.state = state  # oracle contents after the full history
        # with collect_prefixes: oracle contents after each round prefix
        # (prefix_states[r] = state after the first r rounds; [0] = empty).
        # The fault-soak's recovery check: a recovered tree's contents must
        # equal SOME committed prefix state of the witnessed history.
        self.prefix_states = prefix_states

    def summary(self) -> str:
        return (
            f"witness OK: {self.rounds} rounds, {self.lanes} lanes verified, "
            f"{self.eliminated} eliminated ops, {len(self.state)} live keys"
        )


def _check_round(oracle: DictOracle, rec: dict, idx: int) -> int:
    """Replay one round record; returns the verified lane count."""
    ops = rec["ops"]
    keys = rec["keys"]
    vals = rec["vals"]
    results = rec["results"]
    found = rec["found"]
    if not (len(ops) == len(keys) == len(vals) == len(results) == len(found)):
        raise WitnessError(f"record {idx}: ragged lane arrays")
    cap = rec.get("scan_cap")
    exp_res, exp_found, exp_scans = oracle.apply_mixed_round(ops, keys, vals, cap=cap)
    scans = rec.get("scans") or {}
    lanes = 0
    for i, op in enumerate(ops):
        if op == int(OP_NOP):
            continue
        lanes += 1
        if op == int(OP_RANGE):
            got_rows = scans.get(str(i))
            want_rows = [[int(k), int(v)] for k, v in exp_scans[i]]
            if got_rows is not None and got_rows != want_rows:
                raise WitnessError(
                    f"record {idx} (round {rec.get('round')}): range lane {i} "
                    f"[{keys[i]}, {keys[i]}+{vals[i]}) returned rows "
                    f"{got_rows[:4]}… but a sequential history scans "
                    f"{want_rows[:4]}…"
                )
            # the count/found surface must agree even when rows were elided
            if int(results[i]) != len(want_rows) or bool(found[i]) != bool(want_rows):
                raise WitnessError(
                    f"record {idx} (round {rec.get('round')}): range lane {i} "
                    f"count {results[i]} != sequential count {len(want_rows)}"
                )
            continue
        if int(results[i]) != int(exp_res[i]) or bool(found[i]) != bool(exp_found[i]):
            raise WitnessError(
                f"record {idx} (round {rec.get('round')}): lane {i} "
                f"op {op} key {keys[i]} returned "
                f"(result={results[i]}, found={found[i]}) but the arrival-order "
                f"linearization gives (result={exp_res[i]}, found={exp_found[i]})"
            )
    return lanes


def _check_elim_notes(rec: dict, idx: int) -> int:
    """Structural audit of the round's elimination notes; returns the
    eliminated-op count attributed to this round."""
    notes = rec.get("elim") or []
    n_upd = sum(1 for op in rec["ops"] if op in (int(OP_INSERT), int(OP_DELETE)))
    total = 0
    for note in notes:
        total += sum(int(x) for x in note.get("eliminated", []))
        for seg in note.get("segments", []):
            if len(seg.get("lanes", [])) < 2:
                raise WitnessError(
                    f"record {idx}: elim segment for key {seg.get('key')} "
                    f"claims a pairing with < 2 update ops"
                )
    if total > n_upd:
        raise WitnessError(
            f"record {idx}: {total} ops eliminated but only {n_upd} "
            f"update lanes in the round"
        )
    return total


def check_history(records: Sequence[dict], *,
                  collect_prefixes: bool = False) -> WitnessReport:
    """Replay every round record through the oracle; raise
    :class:`WitnessError` on the first illegal transition.  With
    ``collect_prefixes`` the report also carries the oracle state after
    every round prefix — the committed-prefix candidates a crash-recovered
    tree must land on."""
    oracle = DictOracle()
    rounds = lanes = eliminated = 0
    prefixes = [dict(oracle.items())] if collect_prefixes else None
    for idx, rec in enumerate(records):
        if rec.get("kind") != "round":
            continue
        lanes += _check_round(oracle, rec, idx)
        eliminated += _check_elim_notes(rec, idx)
        rounds += 1
        if collect_prefixes:
            prefixes.append(dict(oracle.items()))
    return WitnessReport(rounds, lanes, eliminated, oracle.items(), prefixes)


def check_file(path: str) -> WitnessReport:
    return check_history(Recorder.load(path))


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.witness",
        description="Verify a recorded audit history is a legal sequential "
        "history (linearizability witness).",
    )
    p.add_argument("audit", help="audit .jsonl (recorder export or forensics sidecar)")
    p.add_argument(
        "-q", "--quiet", action="store_true", help="suppress the success summary"
    )
    args = p.parse_args(argv)
    try:
        report = check_file(args.audit)
    except WitnessError as e:
        print(f"{args.audit}: WITNESS FAILED: {e}", file=sys.stderr)
        return 1
    except (OSError, ValueError, KeyError) as e:
        print(f"{args.audit}: unreadable audit log: {e}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"{args.audit}: {report.summary()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
