"""End-to-end training on the PyTorch port: data pipeline → train step on
the host mesh → durable checkpoints → auto-resume — the program of
``train_lm.py`` over ``repro_torch``.

The mesh is ``launch.mesh.make_host_mesh``: one rank, NCCL on the card,
gloo with ``--device cpu``.  The default is a tiny model; ``--preset 100m``
trains a ~100M-parameter qwen2-family config (the same code path, bigger
shapes).

    PYTHONPATH=src python examples/train_lm_torch.py                   # tiny, 40 steps, on the card
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --fail-at 20      # crash+resume demo
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 10
"""
import argparse
import json
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import make_data_iter
from repro_torch.launch.mesh import make_host_mesh, shutdown
from repro_torch.models import reduced
from repro_torch.train import SimulatedFailure, Trainer, TrainerConfig


def make_cfg(preset: str):
    base = get_config("qwen2-0.5b")
    if preset == "tiny":
        return reduced(base, n_layers=2)
    if preset == "100m":
        # ~100M params: 12L d768 12H kv4
        return base.replace(
            n_layers=12, d_model=768, n_heads=12, n_kv=4, d_ff=2048,
            vocab=32768, dtype="float32", rules="tp",
        )
    raise SystemExit(f"unknown preset {preset}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    cfg = make_cfg(args.preset)
    mesh = make_host_mesh(args.device)
    try:
        tcfg = TrainerConfig(
            ckpt_dir=args.ckpt,
            max_steps=args.steps,
            ckpt_every=max(args.steps // 4, 5),
            fail_at_step=args.fail_at,
            log_every=5,
        )
        mk_iter = lambda step: make_data_iter(cfg, batch=args.batch, seq=args.seq, start_step=step)

        trainer = Trainer(cfg, tcfg, mk_iter, mesh=mesh)
        if trainer.resumed_from is not None:
            print(f"[resume] from durable checkpoint @ step {trainer.resumed_from}")
        try:
            out = trainer.run()
        except SimulatedFailure as e:
            print(f"[crash] {e} — rerun this script to observe auto-resume")
            return
        print(json.dumps(out, indent=1, default=str))
    finally:
        shutdown()


if __name__ == "__main__":
    main()
