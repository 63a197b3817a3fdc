"""Multi-pod dry-run of the port: every (arch × shape × mesh) cell's step
traced on meta tensors over a fake world (port of
``src/repro/launch/dryrun.py``).

For each cell ``run_cell``
  1. starts a fake world of 256 (16×16, one pod) or 512 ranks (2×16×16)
     in this process (``torch.distributed``'s ``fake`` backend: no
     process, no network, collectives that move nothing; as JAX sets
     ``XLA_FLAGS`` for 512 host devices first) and builds the production
     mesh over it;
  2. builds the params as meta ``DTensor`` s placed by ``param_shardings``
     under the arch's rule set, and the inputs by ``input_specs``
     (``parallel/sharding.py`` places them: no allocation);
  3. runs the train step (forward, backward, clip and the AdamW update),
     the prefill step or one decode step under ``FlopCounterMode`` and
     ``CollectiveRecorder`` (a ``CommDebugMode``);
  4. records ``status``, ``n_params``, one device's ``memory`` (argument
     and output bytes: the local shards of the step's inputs and outputs;
     temp bytes: the peak of what the step allocates, less its outputs, as
     ``analysis.roofline.PeakMemory`` tracks the meta storages; ``fits``:
     whether argument and temp bytes together fit the card's 80 GB),
     ``cost`` (one device's FLOPs), ``collectives`` (one device's operand
     bytes by kind), ``n_devices`` and ``lower_compile_s`` (the trace's
     seconds), and appends the record to the results JSON (cells already
     there are skipped unless ``--force``).

One device's FLOPs: ``FlopCounterMode`` sees a ``DTensor`` op at its
global shape, and the ops of a local region (the attention kernels' local
shards, the MoE dispatch) at one rank's; so ``cost.flops`` is the
``DTensor`` ops' count divided by the devices plus the local regions'
count, both kept apart in the record.  The temp bytes are those of the
step as the dry-run host runs it: its local regions take the plain
versions of the kernels (the attention's whole score matrix; B6 on the
card keeps none), so they bound the card's from above.  They also hold
what the local regions gather: a decode's attention gathers its rank's
batch rows of a cache whose sequence is split (whole along the
sequence, each step), and the MoE region gathers the expert weights'
FSDP split of ``embed`` (never their ``model`` split); ``fits`` false
marks a cell that cannot run so.  The port counts
every layer it runs, where XLA's cost analysis
counts a scanned layer body once, so these FLOPs are not comparable with
the JAX package's ``results/dryrun.json``.

Usage (writes ``results/dryrun_torch.json``; ``--suite opt``:
``results/dryrun_torch_opt.json``):
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k --mesh multi
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import SHAPES, all_cells, cell_status, get_config

RESULTS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..", "results"))


def _cell_id(arch, shape, mesh_kind):
    return f"{arch}|{shape}|{mesh_kind}"


def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake world of ``n`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _local_bytes(tree) -> int:
    """Bytes of one rank's shards of every tensor in ``tree``."""
    if tree is None:
        return 0
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    return sum(_local_bytes(v) for v in tree)


def run_cell(arch: str, shape_name: str, mesh_kind: str, overrides=None) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch._shardmap_compat import count_region_flops, place
    from repro_torch.analysis.roofline import (
        HBM_BYTES,
        CollectiveRecorder,
        PeakMemory,
        collective_bytes,
    )
    from repro_torch.launch.inputs import input_specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import backbone, count_params
    from repro_torch.models.params import map_specs
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel.sharding import batch_shardings, cache_shardings
    from repro_torch.train.step import (
        make_prefill_step,
        make_serve_step,
        make_train_step,
        state_shardings,
        token_sharding,
    )

    cfg = get_config(arch)
    overrides = dict(overrides or {})
    param_dtype = overrides.pop("param_dtype", None)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    status = cell_status(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": status,
           "kind": shape.kind}
    if status != "run":
        return rec

    n_devices = 512 if mesh_kind == "multi" else 256
    fake_world(n_devices)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device_type="cpu")
    t0 = time.time()
    spec_tree = backbone.model_spec(cfg)
    dtype = getattr(torch, param_dtype) if param_dtype else None  # serving-weight dtype (opt)
    params = map_specs(lambda path, s: torch.empty(s.shape, dtype=dtype or s.dtype, device="meta"),
                       spec_tree)
    shardings = state_shardings(cfg, mesh)
    params = place(params, shardings["params"])
    rec["n_params"] = count_params(spec_tree)

    # the arguments are placed before the trackers open: the global meta
    # inputs (a whole decode cache) are never the step's own memory
    specs = input_specs(cfg, shape)
    if shape.kind == "decode":
        args = (params, place(specs["cache"], cache_shardings(cfg, shape.batch, shape.seq, mesh)),
                place(specs["tokens"], token_sharding(mesh, shape.batch)))
    else:
        batch = place(specs, batch_shardings(cfg, specs, mesh))
        args = (params, adamw_init(params), batch) if shape.kind == "train" else (params, batch)
    with PeakMemory() as mem, count_region_flops() as regions, \
            FlopCounterMode(display=False) as flops, CollectiveRecorder() as comm:
        if shape.kind == "train":
            outs = tuple(make_train_step(cfg, mesh, donate=True)(*args, 0))
        elif shape.kind == "prefill":
            outs = make_prefill_step(cfg, mesh)(*args)
        else:  # decode: one token at the cache's last position
            outs = make_serve_step(cfg, mesh, shape.batch, shape.seq)(*args, shape.seq - 1)
    rec["lower_compile_s"] = round(time.time() - t0, 1)
    arg_bytes, out_bytes = _local_bytes(args), _local_bytes(outs)
    temp = max(0, mem.peak - out_bytes)
    rec["memory"] = {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
                     "temp_size_in_bytes": temp}
    rec["fits"] = arg_bytes + temp <= HBM_BYTES
    local = float(sum(regions))
    dtensor = float(flops.get_total_flops()) - local
    rec["cost"] = {
        "flops": dtensor / n_devices + local,
        "dtensor_flops_global": dtensor,
        "local_region_flops": local,
        "bytes_accessed": float(arg_bytes + out_bytes),
    }
    rec["collectives"] = collective_bytes(comm.records)
    rec["n_devices"] = n_devices
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--suite", default="baseline", choices=["baseline", "opt"],
                    help="opt = the optimized variants (configs/optimized.py)")
    args = ap.parse_args(argv)

    fname = "dryrun_torch.json" if args.suite == "baseline" else "dryrun_torch_opt.json"
    out_path = args.out or os.path.join(RESULTS, fname)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    if args.list:
        for arch, cfg, shape, status in all_cells():
            for mk in ("single", "multi"):
                cid = _cell_id(arch, shape.name, mk)
                done = "✓" if cid in results and results[cid].get("ok") else " "
                print(f"[{done}] {cid}: {status}")
        return results

    from repro_torch.configs.optimized import OPTIMIZED, overrides_for

    cells = []
    for arch, cfg, shape, status in all_cells():
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape.name != args.shape:
            continue
        if args.suite == "opt" and (arch, shape.name) not in OPTIMIZED:
            continue
        for mk in ("single", "multi"):
            if args.mesh and mk != args.mesh:
                continue
            cells.append((arch, shape.name, mk))

    for arch, shape_name, mk in cells:
        cid = _cell_id(arch, shape_name, mk)
        if not args.force and cid in results and results[cid].get("ok"):
            print(f"skip (cached): {cid}")
            continue
        print(f"=== {cid} ===", flush=True)
        try:
            ov = overrides_for(arch, shape_name) if args.suite == "opt" else None
            rec = run_cell(arch, shape_name, mk, overrides=ov)
            if ov:
                rec["overrides"] = ov
            rec["ok"] = True
            if rec["status"] == "run":
                print(f"  ok in {rec['lower_compile_s']}s; flops/device={rec['cost']['flops']:.3e} "
                      f"arg_bytes/device={rec['memory']['argument_size_in_bytes']:.3e} "
                      f"coll_bytes/device={rec['collectives']['total_bytes']:.3e} "
                      f"fits={rec['fits']}", flush=True)
            else:
                print(f"  {rec['status']}")
        except Exception as e:  # noqa: BLE001 — record failures, keep going
            rec = {
                "arch": arch,
                "shape": shape_name,
                "mesh": mk,
                "ok": False,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
            print(f"  FAIL: {rec['error']}")
        results[cid] = rec
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells ok → {out_path}")
    return results


if __name__ == "__main__":
    main()
