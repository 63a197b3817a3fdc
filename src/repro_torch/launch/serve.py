"""Serving launcher: continuous-batching engine with the Elim-ABtree prefix
index, on the CUDA card (the same arguments and output as
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --requests 16 --index elim
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import reduced
from repro_torch.serve import Request, ServeEngine


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--index", default="elim", choices=["elim", "occ"])
    ap.add_argument("--hot-frac", type=float, default=0.7,
                    help="fraction of requests sharing a hot system prompt")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch), n_layers=2)
    eng = ServeEngine(cfg, max_batch=4, s_max=128, n_pages=256, index_mode=args.index,
                      device=device)
    rng = np.random.default_rng(0)
    hot_prompt = rng.integers(0, cfg.vocab, 16).tolist()
    for rid in range(args.requests):
        if rng.random() < args.hot_frac:
            prompt = list(hot_prompt)
        else:
            prompt = rng.integers(0, cfg.vocab, 16).tolist()
        eng.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))
    done = eng.run_until_done()
    print(json.dumps(eng.stats(), indent=1))
    print(f"completed {len(done)} requests")


if __name__ == "__main__":
    main()
