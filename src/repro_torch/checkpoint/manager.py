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
the other's checkpoints.  ``restore`` puts the leaves on the caller's
device; restoring onto another mesh (elastic re-sharding) waits for the
parallel layer (ROADMAP.md queue A, item 9).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

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
    if isinstance(tree, dict):
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


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        flat = _flatten(state)
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


def restore(directory: str, step: int, like: Any, device=None) -> Any:
    """Rebuild the tree ``like`` (structure template) from a checkpoint,
    every leaf a tensor on ``device`` (default the CUDA card; raises
    without one)."""
    device = resolve_device(device, "restore")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)["index"]

    loaded = {
        name: tensor_from_numpy(np.load(os.path.join(d, index[name])), device)
        for name in _flatten(like)
    }

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
