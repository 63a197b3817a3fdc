"""Training launcher, on the CUDA card (the flags of
``repro.launch.train`` that apply to one device).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 100 --batch 8 --seq 256 --ckpt <dir>

Without ``--reduced`` it trains the arch at its published width and depth;
``--reduced`` gives the tiny same-family config.  Training auto-resumes
from the newest durable checkpoint in ``--ckpt`` (default: a directory
under the system's temporary directory).  Without ``--mesh`` it trains on
one device; ``--mesh host`` on the 1-rank ``(data, model)`` mesh
(``launch.mesh.make_host_mesh``: DTensor params and batches); ``single``
and ``multi`` ask for the production meshes, which need a world of 256 /
512 ranks and otherwise raise, naming the dry-run.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import make_data_iter
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
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
    ap.add_argument("--mesh", default=None, choices=["host", "single", "multi"],
                    help="host: a 1-rank mesh; single / multi: the (16,16) / (2,16,16) "
                         "production meshes (a world of 256 / 512 ranks)")
    return ap.parse_args(argv)


def build_mesh(kind, device=None):
    """The mesh ``--mesh kind`` names (None: no mesh)."""
    if kind is None:
        return None
    if kind == "host":
        return make_host_mesh(device)
    return make_production_mesh(multi_pod=kind == "multi",
                                device_type="cpu" if str(device) == "cpu" else "cuda")


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
    return Trainer(cfg, tcfg, mk_iter, device=device, mesh=build_mesh(args.mesh, device))


def main(argv=None, device=None):
    trainer = build_trainer(parse_args(argv), device)
    if trainer.resumed_from is not None:
        print(f"resumed from durable checkpoint at step {trainer.resumed_from}")
    out = trainer.run()
    print(json.dumps(out, indent=1, default=str))
    return out


if __name__ == "__main__":
    main()
