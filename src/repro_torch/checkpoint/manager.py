"""Durable training checkpoints: the link-and-persist protocol applied to
the train state (port of ``src/repro/checkpoint/manager.py``).

Protocol per checkpoint step:
  1. write every tree leaf to `step_<n>.tmp/<leaf>.npy` + fsync  (flush)
  2. fsync the tmp dir, os.replace → `step_<n>/`                 (link)
  3. write MANIFEST.tmp naming the step, fsync, os.replace → MANIFEST,
     fsync dir                                                   (persist)

A crash at any point recovers to the last committed manifest.  The files,
their names (``_flatten``: dict keys and NamedTuple fields joined by dots)
and ``index.json`` are those of the JAX package, so either package restores
the other's checkpoints.

Checkpoints are **mesh-agnostic** (elastic): a ``DTensor`` leaf is stored
as its global array (``_gather_to_first``: a collective every rank
joins, in which each rank sends its shard to rank 0 alone, which writes;
no other rank ever holds a whole leaf), and ``restore(...,
shardings=...)`` places each leaf on any mesh whose axes divide its
shape, so a checkpoint written under a mesh restores without one, and
the reverse.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch._shardmap_compat import NamedSharding, distribute
from repro_torch.interop import tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels._lib import resolve_device


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten(tree, prefix=""):
    flat = {}
    if isinstance(tree, NamedSharding):  # a leaf of a shardings tree
        flat[prefix[:-1]] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}."))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            flat.update(_flatten(getattr(tree, k), f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}."))
    else:
        flat[prefix[:-1]] = tree
    return flat


def _gather_to_first(x: DTensor):
    """``x``'s global value on rank 0, None on every other rank.  Each
    rank's shard (padded to the largest shard's shape, for a split that
    does not divide) and its offset go to rank 0 alone, which puts them in
    place; a shard replicated over a mesh dim arrives once a copy and is
    written again, to the same place.  The mesh spans the world."""
    mesh = x.device_mesh
    size, offset = compute_local_shape_and_global_offset(x.shape, mesh, x.placements)
    cap = list(x.shape)
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            cap[p.dim] = -(-cap[p.dim] // mesh.size(i))
    local = x.to_local()
    buf = local.new_zeros(cap)
    buf[tuple(slice(0, n) for n in size)] = local
    where = torch.tensor(list(size) + list(offset), dtype=torch.int64, device=local.device)
    first = dist.get_rank() == 0
    world = dist.get_world_size()
    bufs = [torch.empty_like(buf) for _ in range(world)] if first else None
    wheres = [torch.empty_like(where) for _ in range(world)] if first else None
    dist.gather(buf, bufs, dst=0)
    dist.gather(where, wheres, dst=0)
    if not first:
        return None
    out = local.new_empty(x.shape)
    n = x.dim()
    for b, w in zip(bufs, wheres):
        sz, off = w[:n].tolist(), w[n:].tolist()
        out[tuple(slice(o, o + k) for o, k in zip(off, sz))] = b[tuple(slice(0, k) for k in sz)]
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        flat = _flatten(state)
        if any(isinstance(leaf, DTensor) for leaf in flat.values()):
            flat = {k: _gather_to_first(v) if isinstance(v, DTensor) else v
                    for k, v in flat.items()}
            if dist.get_rank() != 0:
                return
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        index = {}
        for name, leaf in flat.items():
            arr = tensor_to_numpy(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            fn = re.sub(r"[^\w.]", "_", name) + ".npy"
            with open(os.path.join(tmp, fn), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())  # flush before link
            index[name] = fn
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump({"index": index, "extra": extra or {}}, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)  # link
        # persist: manifest commit
        mtmp = os.path.join(self.dir, "MANIFEST.tmp")
        with open(mtmp, "w") as f:
            json.dump({"latest_step": step}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, os.path.join(self.dir, "MANIFEST"))
        _fsync_dir(self.dir)
        self._gc(step)

    def _gc(self, latest: int):
        steps = sorted(self._steps())
        for s in steps[: -self.keep]:
            if s != latest:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def _steps(self):
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m:
                out.append(int(m.group(1)))
        return out


def latest_step(directory: str) -> Optional[int]:
    mpath = os.path.join(directory, "MANIFEST")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        return json.load(f)["latest_step"]


def restore(directory: str, step: int, like: Any, shardings: Any = None, device=None) -> Any:
    """Rebuild the tree ``like`` (structure template) from a checkpoint,
    every leaf a tensor on ``device`` (default the CUDA card; raises
    without one).  Where ``shardings`` (a matching tree of
    ``NamedSharding``, None at a leaf to keep it whole) gives a leaf a
    sharding, the leaf is a ``DTensor`` placed by it on its mesh, whose
    device type is then the default: elastic re-sharding on restore."""
    flat_shard = _flatten(shardings) if shardings is not None else {}
    if device is None:
        meshes = [s.mesh for s in flat_shard.values() if s is not None]
        device = meshes[0].device_type if meshes else None
    device = resolve_device(device, "restore")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)["index"]

    loaded = {}
    for name in _flatten(like):
        x = tensor_from_numpy(np.load(os.path.join(d, index[name])), device)
        sharding = flat_shard.get(name)
        loaded[name] = distribute(x, sharding) if sharding is not None else x

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}.") for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(
                **{k: rebuild(getattr(tree, k), f"{prefix}{k}.") for k in tree._fields}
            )
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}.") for i, v in enumerate(tree))
        return loaded[prefix[:-1]]

    return rebuild(like)


def checkpoint_extra(directory: str, step: int) -> dict:
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        return json.load(f)["extra"]
