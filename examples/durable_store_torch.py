"""Durability on the PyTorch port: crash injection at a protocol step,
recovery to the last committed round, and the p-Elim vs p-OCC flush-cost
gap — the program of ``durable_store.py`` over ``repro_torch``.

    PYTHONPATH=src python examples/durable_store_torch.py                # on the CUDA card
    PYTHONPATH=src python examples/durable_store_torch.py --device cpu   # plain versions on the host
"""
import argparse
import tempfile

import numpy as np

from repro_torch.core import (CrashPoint, DurableABTree, OP_DELETE, OP_INSERT, SimulatedCrash,
                              TreeConfig, recover)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    device = args.device
    rng = np.random.default_rng(0)

    with tempfile.TemporaryDirectory(prefix="durable_store_") as root:
        # --- crash mid-manifest: the round never becomes durable ---------------
        d = tempfile.mkdtemp(prefix="crash_demo_", dir=root)
        t = DurableABTree(d, TreeConfig(capacity=1024), crash=CrashPoint("mid_manifest", at_commit=2),
                          device=device)
        t.apply_round([OP_INSERT] * 4, [1, 2, 3, 4], [10, 20, 30, 40])  # commit 1 ✓
        try:
            t.apply_round([OP_INSERT] * 2, [5, 6], [50, 60])  # commit 2 ✗ (crash)
        except SimulatedCrash as e:
            print("crashed:", e)
        r = recover(d, device=device)
        print("recovered (crashed round absent):", r.tree.items())
        assert r.tree.items() == {1: 10, 2: 20, 3: 30, 4: 40}

        # --- p-Elim vs p-OCC on a hot-key churn workload -----------------------
        stats = {}
        for mode in ("elim", "occ"):
            d2 = tempfile.mkdtemp(prefix=f"p{mode}_", dir=root)
            dt = DurableABTree(d2, TreeConfig(capacity=1024), mode=mode, device=device)
            for _ in range(4):
                ops = [OP_INSERT, OP_DELETE] * 16
                keys = (np.minimum(rng.zipf(1.6, 32), 8)).tolist()
                dt.apply_round(ops, keys, list(range(32)))
            stats[mode] = dt.stats()
            dt.close()
            print(
                f"p-{mode}: commits={stats[mode]['commits']} "
                f"fsyncs={stats[mode]['fsyncs']} flush_bytes={stats[mode]['flush_bytes']}"
            )
        assert stats["elim"]["fsyncs"] < stats["occ"]["fsyncs"]
        print("p-Elim needs fewer flushes — the paper's Table 1 effect")


if __name__ == "__main__":
    main()
