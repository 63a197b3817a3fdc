"""The control runs that show the comparison deciding ``correct`` fails a
run that breaks one of the guarantees the configurations state.  The
benchmark's own runs never run it.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --rounds 250

* ``elim-2m.*``: the plain reference with one guarantee broken is put in
  the program's place (``--broken range_after_writes``, the default for a
  mix with range lanes, or ``round_start_reads``) and driven through the
  whole run: load, warm-up and ``--rounds`` window rounds, then the check.
* a durable cell: the program's own weaker path, group commit of 8 rounds
  (``group_commit_every=8``, no age bound), driven for ``--rounds``
  window rounds; the run's crash then fires at the next group boundary,
  so 7 acknowledged rounds are absorbed and not on disk.

Each seed prints one JSON line with the checks; the run is the control's
failure if any check exceeds its limit.
"""
import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

import numpy as np  # noqa: E402

from bench.reference import EMPTY, Dictionary  # noqa: E402

GROUP = 8


class _Metrics:
    def value(self, name):
        return 0

    def histogram_values(self, name):
        return []


class ReferenceHolder:
    """The plain reference behind the round API (``apply_round``,
    ``items``, ``stats``, ``metrics``), with ``broken`` as in
    ``bench.reference.dictionary``."""

    def __init__(self, broken: str):
        self.ref = Dictionary(broken)
        self.metrics = _Metrics()

    def apply_round(self, ops, keys, vals=None, *, scan_cap: int = 128):
        ans = self.ref.apply_round(ops, keys, vals, scan_cap)
        n = np.asarray(ops).size
        scan = None
        if ans.range_lanes.size:
            k = np.full((n, scan_cap), EMPTY, np.int64)
            v = np.zeros((n, scan_cap), np.int64)
            c = np.zeros(n, np.int32)
            t = np.zeros(n, bool)
            k[ans.range_lanes], v[ans.range_lanes] = ans.row_keys, ans.row_vals
            c[ans.range_lanes], t[ans.range_lanes] = ans.count, ans.truncated
            scan = SimpleNamespace(keys=k, vals=v, count=c, truncated=t)
        return SimpleNamespace(results=ans.results, found=ans.found, scan=scan)

    def items(self):
        return dict(self.ref.d)

    def stats(self):
        return {"eliminated": 0}


def run_control(workload: str, seed: int, rounds: int, broken=None, device="cuda", **kw) -> dict:
    from bench import harness

    spec = ROOT / "BENCHMARK.json"
    c = harness.resolve(spec, workload)
    config = dict(c["config"], **kw.get("config_override", {}))
    if harness.is_durable(config):
        args = dict(config.get("args", {}), group_commit_every=GROUP, group_commit_max_wait_s=1e9)
        kw["config_override"] = dict(kw.get("config_override", {}), args=args)
        return harness.run_cell(spec, workload, seed, 1e9, False, device=device,
                                max_rounds=rounds, **kw)
    if broken is None:
        broken = "range_after_writes" if "range" in c["mix"]["ops"] else "round_start_reads"
    return harness.run_cell(spec, workload, seed, 1e9, False, device="cpu", max_rounds=rounds,
                            make=lambda config, device, journal: ReferenceHolder(broken), **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="control runs of the benchmark's comparison")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rounds", type=int, default=250)
    ap.add_argument("--broken", default=None)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_control(args.workload, seed, args.rounds, args.broken)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "rounds": res["rounds"], "crash": res.get("crash"),
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
