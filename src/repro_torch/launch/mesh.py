"""Device meshes over ``torch.distributed`` (port of
``src/repro/launch/mesh.py``).

Functions, not module constants: importing this module starts no process
group.  ``make_mesh(shape, axes)`` lays the world's ranks out row-major
over named axes, as ``jax.make_mesh`` lays out devices; the world must
hold exactly that many ranks.  ``make_host_mesh`` starts a 1-rank world of
its own when there is none (a ``FileStore`` in a fresh temporary
directory: no network), ``nccl`` on the card, ``gloo`` on the CPU.  The
production meshes are the JAX package's: ``(16, 16)`` over ``(data,
model)`` on one pod, ``(2, 16, 16)`` over ``(pod, data, model)`` on two;
a world of another size raises, and names the dry-run
(``python -m repro_torch.launch.dryrun``), which builds them over a fake
world of 256 / 512 ranks in one process.  ``shutdown()`` ends the world
and removes the store's directory.
"""
from __future__ import annotations

import math
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels._lib import resolve_device

_STORE_DIRS: list = []


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the world's ranks,
    rank-major in row order."""
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(
            f"a {tuple(shape)} mesh needs a world of {n} ranks, this one has {world}: on fewer "
            "devices, account for it with the dry-run (python -m repro_torch.launch.dryrun), "
            "which builds it over a fake world")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_host_mesh(device=None) -> DeviceMesh:
    """A 1-rank ``("data", "model")`` mesh on ``device`` (default the CUDA
    card, over ``nccl``; ``device="cpu"``: ``gloo``).  Starts the 1-rank
    world if none is running."""
    dev = resolve_device(device, "make_host_mesh")
    if not dist.is_initialized():
        store_dir = tempfile.mkdtemp(prefix="repro_torch_store_")
        _STORE_DIRS.append(store_dir)
        store = dist.FileStore(f"{store_dir}/store", 1)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store,
                                rank=0, world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    return make_mesh((1, 1), ("data", "model"), dev.type)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The production topology over a world of 256 (one pod) or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def shutdown() -> None:
    """End the process group and remove the stores ``make_host_mesh`` made."""
    if dist.is_initialized():
        dist.destroy_process_group()
    while _STORE_DIRS:
        shutil.rmtree(_STORE_DIRS.pop(), ignore_errors=True)
