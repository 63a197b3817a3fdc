"""Serving on the PyTorch port: continuous batching + paged KV + the
Elim-ABtree prefix index.  A skewed request mix (hot shared system prompt)
shows prefix-cache hits and the index's elimination stats — the program of
``serve_engine.py`` over ``repro_torch``.

    PYTHONPATH=src python examples/serve_engine_torch.py                # on the CUDA card
    PYTHONPATH=src python examples/serve_engine_torch.py --device cpu   # plain versions on the host
"""
import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import reduced
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.pages import PAGE


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    cfg = reduced(get_config("qwen2-0.5b"), n_layers=1)
    eng = ServeEngine(cfg, max_batch=4, s_max=8 * PAGE, n_pages=128, index_mode="elim",
                      device=args.device)
    rng = np.random.default_rng(0)
    hot = rng.integers(0, cfg.vocab, PAGE).tolist()  # shared system prompt
    for rid in range(12):
        prompt = list(hot) if rng.random() < 0.75 else rng.integers(0, cfg.vocab, PAGE).tolist()
        eng.submit(Request(rid=rid, prompt=prompt, max_new=4))
    done = eng.run_until_done()
    print(f"served {len(done)} requests")
    print(json.dumps(eng.stats(), indent=1))


if __name__ == "__main__":
    main()
