"""The ambient mesh and sharding constraints usable from deep inside model
code (port of ``src/repro/parallel/ctx.py``).

JAX reads the mesh of the enclosing ``with mesh:``; the port's counterpart
is ``with use_mesh(mesh):``, which also lets plain tensors (positions,
masks, tables) mix with ``DTensor`` s as replicated values
(``implicit_replication``).  ``constrain(x, axes...)`` resolves axis names
against the ambient mesh: missing axes and non-dividing dims degrade to
replication; with no mesh, or on a plain tensor, it is the identity, so
model code stays runnable on one device."""
from __future__ import annotations

import contextvars
import math
from contextlib import contextmanager

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch._shardmap_compat import PartitionSpec, placements

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


def current_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _MESH.get()


@contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh (None: no mesh) for the block.  It
    nests: ``implicit_replication`` turns a process-wide switch off on
    leaving, so it is entered only where the switch is off (a checkpoint's
    recompute re-enters the mesh in the middle of a backward that needs
    the switch on after it)."""
    token = _MESH.set(mesh)
    try:
        if mesh is None or getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
            yield mesh
        else:
            with implicit_replication():
                yield mesh
    finally:
        _MESH.reset(token)


def constrain(x, *axes):
    """axes: one entry per dim — None | axis name | tuple of candidate axis
    names (filtered to those present; dropped unless they divide the dim).
    A ``DTensor`` is redistributed to the resolved placements."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    fixed = []
    for dim, ax in zip(x.shape, axes):
        if ax is None:
            fixed.append(None)
            continue
        cand = ax if isinstance(ax, tuple) else (ax,)
        sel = tuple(a for a in cand if a in sizes)
        size = math.prod(sizes[a] for a in sel)
        fixed.append(sel if sel and dim % size == 0 else None)
    return x.redistribute(mesh, placements(PartitionSpec(*fixed), mesh))


DATA_AXES = ("pod", "data")
