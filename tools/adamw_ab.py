"""A/B of AdamW bodies inside the qwen2-0.5b train step on the card.

Each argument ``name=path`` names a copy of ``src/repro_torch/optim/adamw.py``.
The script builds the launcher's Trainer on full qwen2-0.5b (batch 8 x 1,024),
puts each copy's ``clip_by_global_norm`` and ``adamw_update`` into the train
step the Trainer runs, and times the variants in the order given, then in
reverse (A B C C B A, on one card and one host).  A copy whose
``adamw_update`` takes no ``donate`` runs the step without donation, as the
step that returned new trees did.  For each turn it prints the step's wall
ms (p50 of ``STEPS`` steps, each timed to its loss on the host), the device
busy ms of one profiled step (the union of its device events) and the
optimizer alone (clip + update on seeded grads: host wall ms and CUDA-event
ms, p50 of ``OPT_REPS``), then one JSON line.  Compare its variants only
within one run.

    mkdir -p build/ab
    git show <commit>:src/repro_torch/optim/adamw.py > build/ab/adamw_old.py
    python3 tools/adamw_ab.py old=build/ab/adamw_old.py new=src/repro_torch/optim/adamw.py

It needs a CUDA card and imports nothing of JAX.
"""
from __future__ import annotations

import importlib
import importlib.util
import inspect
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen2-0.5b"
BATCH, SEQ = 8, 1024
WARMUP, STEPS, OPT_REPS = 2, 8, 5
DEVICE = "cuda"


def load(name, path):
    spec = importlib.util.spec_from_file_location(f"adamw_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def busy_ms(torch, prof):
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("adamw_ab: no CUDA device")
    variants = dict(a.split("=", 1) for a in argv)
    if not variants:
        raise SystemExit(__doc__)
    mods = {n: load(n, p) for n, p in variants.items()}
    device = torch.device(DEVICE)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(gpu, flush=True)

    from repro_torch.data import make_data_iter
    from repro_torch.launch import train as launch
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import make_train_step

    step_mod = importlib.import_module("repro_torch.train.step")

    with tempfile.TemporaryDirectory() as ckpt:
        trainer = launch.build_trainer(launch.parse_args(
            ["--arch", ARCH, "--batch", str(BATCH), "--seq", str(SEQ), "--ckpt", ckpt]), device)
    cfg, tcfg = trainer.cfg, trainer.tcfg
    batch = {k: torch.from_numpy(x).to(device)
             for k, x in next(make_data_iter(cfg, BATCH, SEQ, seed=0)).items()}
    gen = torch.Generator(device=device).manual_seed(0)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=device) * 1e-3,
                     trainer.params)
    params, opt = trainer.params, trainer.opt
    del trainer
    results = []
    order = list(mods) + list(mods)[::-1]
    for turn, name in enumerate(order):
        mod = mods[name]
        donate = "donate" in inspect.signature(mod.adamw_update).parameters
        kw = {"donate": donate} if donate else {}
        clip, update = mod.clip_by_global_norm, mod.adamw_update
        if not donate:  # the step passes donate=False, which this copy does not take
            clip = lambda g, c, donate, f=clip: f(g, c)
            update = lambda g, s, p, lr, donate, f=update: f(g, s, p, lr)
        step_mod.adamw_update, step_mod.clip_by_global_norm = update, clip
        step_fn = make_train_step(cfg, lr_peak=tcfg.lr_peak, grad_clip=tcfg.grad_clip,
                                  donate=donate)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        walls = []
        for i in range(WARMUP + STEPS):
            t0 = time.perf_counter()
            out = step_fn(params, opt, batch, 100 + i)
            float(out.metrics["loss"])
            walls.append(time.perf_counter() - t0)
            params, opt = out.params, out.opt_state
            del out
        peak = torch.cuda.max_memory_allocated(device)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = step_fn(params, opt, batch, 200)
            float(out.metrics["loss"])
            prof_wall = time.perf_counter() - t0
        params, opt = out.params, out.opt_state
        del out
        dev = busy_ms(torch, prof)
        del prof
        opt_wall, opt_dev = [], []
        for _ in range(OPT_REPS):
            g = tree_map(torch.clone, grads)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            g, _ = mod.clip_by_global_norm(g, tcfg.grad_clip, **kw)
            params, opt = mod.adamw_update(g, opt, params, torch.tensor(1e-4, device=device), **kw)
            e1.record()
            torch.cuda.synchronize()
            opt_wall.append((time.perf_counter() - t0) * 1e3)
            opt_dev.append(e0.elapsed_time(e1))
            del g
        row = {"turn": turn, "variant": name, "donate": donate,
               "step_ms_p50": float(np.percentile(walls[WARMUP:], 50) * 1e3),
               "step_ms": [w * 1e3 for w in walls[WARMUP:]],
               "profiled_wall_ms": prof_wall * 1e3, "device_busy_ms": dev,
               "optimizer_wall_ms_p50": float(np.percentile(opt_wall, 50)),
               "optimizer_event_ms_p50": float(np.percentile(opt_dev, 50)),
               "max_memory_allocated": int(peak)}
        print(json.dumps(row), flush=True)
        results.append(row)
    print(json.dumps({"adamw_ab": {"gpu": gpu, "arch": ARCH, "batch": BATCH, "seq": SEQ,
                                   "variants": variants, "turns": results}}))


if __name__ == "__main__":
    main(sys.argv[1:])
