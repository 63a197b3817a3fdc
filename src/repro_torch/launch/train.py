"""Training launcher, on the CUDA card (the flags of
``repro.launch.train`` that apply to one device).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 100 --batch 8 --seq 256 --ckpt <dir>

Without ``--reduced`` it trains the arch at its published width and depth;
``--reduced`` gives the tiny same-family config.  Training auto-resumes
from the newest durable checkpoint in ``--ckpt`` (default: a directory
under the system's temporary directory).  ``--mesh`` is refused: the port
has no parallel layer yet (ROADMAP.md queue A, item 9).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import make_data_iter
from repro_torch.models import reduced
from repro_torch.train import Trainer, TrainerConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None, help="inject a crash (testing)")
    ap.add_argument("--mesh", default=None,
                    help="not supported: the port runs on one device (ROADMAP.md queue A, item 9)")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        ap.error("--mesh is not ported yet: the port trains on one device "
                 "(ROADMAP.md queue A, item 9: parallelism)")
    return args


def build_trainer(args, device=None) -> Trainer:
    """The Trainer the launcher runs for parsed ``args``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tcfg = TrainerConfig(
        ckpt_dir=args.ckpt,
        ckpt_every=args.ckpt_every,
        max_steps=args.steps,
        microbatch=args.microbatch,
        fail_at_step=args.fail_at,
    )
    mk_iter = lambda step: make_data_iter(cfg, batch=args.batch, seq=args.seq, start_step=step)
    return Trainer(cfg, tcfg, mk_iter, device=device)


def main(argv=None, device=None):
    trainer = build_trainer(parse_args(argv), device)
    if trainer.resumed_from is not None:
        print(f"resumed from durable checkpoint at step {trainer.resumed_from}")
    out = trainer.run()
    print(json.dumps(out, indent=1, default=str))
    return out


if __name__ == "__main__":
    main()
