"""Run one benchmark cell once and print its result as one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with an NVIDIA card.  With ``--trace 0`` the
line holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics.  The numbers compared with the plain reference close standard
error and the line, each beside its limit.  Exits non-zero, printing no
result, without a CUDA card, or if the process holds JAX or the JAX package
once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout (the program's
# own kernel libraries go to build/repro_torch)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench" / "triton")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the program's host code is one Python
# thread, and idle OpenMP or BLAS workers only take cores from it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    cell = harness.resolve(ROOT / "BENCHMARK.json", args.workload)["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"bench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT / "BENCHMARK.json", args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: the process holds {', '.join(bad)} after the window", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
