"""Mesh vocabulary of the port: partition specs, named shardings and a
``shard_map`` over ``DTensor`` (the counterpart of
``src/repro/_shardmap_compat.py``, which wraps JAX's two ``shard_map``
spellings).

* ``PartitionSpec(*entries)``: one entry per tensor dim, each ``None``
  (replicated), a mesh axis name, or a tuple of names (the dim split over
  all of them, the first the major one), as JAX's ``PartitionSpec``.
* ``NamedSharding(mesh, spec)``: a spec on a mesh, as JAX's.  ``mesh`` is a
  ``DeviceMesh`` or a ``{axis name: size}`` mapping; the sharding helpers
  read only the axis sizes, so they run on a mapping with no process group.
* ``placements(spec, mesh)``: the ``DTensor`` placements of a spec, one per
  mesh dim: ``Shard(d)`` on every mesh dim named by tensor dim ``d``,
  ``Replicate()`` elsewhere.  Where a dim is split over several axes,
  ``DTensor`` splits it in mesh-dim order, not in the spec's order: under
  ``("model", "pod", "data")`` on a ``(pod, data, model)`` mesh each rank
  holds a chunk of the same size as under JAX, but not the same chunk
  (JAX makes ``model`` the major axis of the split, ``DTensor`` ``pod``).
  Values and local shapes agree; which rank holds which rows does not.
* ``shard_map_compat(fn, *, mesh, in_specs, out_specs, manual,
  partial=())``: ``fn`` on each rank's local shards of its arguments
  (``to_local`` / ``from_local``, which is what ``local_map`` does, here
  over trees of tensors).  Inputs are redistributed to their specs over
  the ``manual`` axes and replicated over every other axis: there is no
  partitioner to keep an axis "auto" inside the body, so the body sees
  whole tensors along those axes, unless it takes such an axis by hand
  (it names the axis in ``manual`` and in the specs of the inputs it
  splits, and its outputs are partial sums over the ``partial`` axes, as
  a row-split product's are).  A plain tensor argument is the global
  value, present on every rank.  The gradient of an input replicated over
  a manual axis is a partial sum over that axis (each shard's body adds
  its part), as the transpose of JAX's ``shard_map`` makes it.

It imports only torch, so ``models`` and ``parallel`` both use it without
an import cycle.
"""
from __future__ import annotations

import contextvars
import math
from contextlib import contextmanager
from typing import Any, Mapping, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.utils import _pytree as pytree


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def check_unique(spec) -> None:
    """Raise if ``spec`` maps one mesh axis to two dims (JAX's
    ``DuplicateSpecError``)."""
    seen = [a for entry in spec for a in entry_axes(entry)]
    if len(seen) != len(set(seen)):
        raise ValueError(f"{spec!r} maps a mesh axis to more than one dim")


def placements(spec, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh`` (see the module
    docstring for the order of a dim split over several axes)."""
    check_unique(spec)
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def local_shape(shape, sharding: NamedSharding) -> tuple:
    """One rank's shard shape of a tensor of ``shape`` (the specs only
    name axes whose sizes divide their dims)."""
    sizes = axis_sizes(sharding.mesh)
    out = list(shape)
    for d, entry in enumerate(sharding.spec):
        out[d] //= math.prod(sizes[a] for a in entry_axes(entry))
    return tuple(out)


def distribute(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``x`` (the global value, on every rank) as a ``DTensor`` placed by
    ``sharding``; a meta tensor becomes a meta ``DTensor`` of its local
    shard, with no collective."""
    mesh, pl = sharding.mesh, sharding.placements
    if x.is_meta:
        local = torch.empty(local_shape(x.shape, sharding), dtype=x.dtype, device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=x.shape,
                                  stride=x.stride())
    return distribute_tensor(x, mesh, pl)


def place(tree, shardings):
    """Every plain tensor of ``tree`` placed by its ``NamedSharding`` in the
    matching tree ``shardings`` (``distribute``); a ``DTensor`` leaf, or a
    leaf whose sharding is None, is kept as it is.  Trees: dicts and
    NamedTuples."""
    if shardings is None or tree is None:
        return tree
    if isinstance(shardings, NamedSharding):
        return tree if isinstance(tree, DTensor) else distribute(tree, shardings)
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    return type(tree)(*(place(v, s) for v, s in zip(tree, shardings)))


def replicated(x: torch.Tensor, mesh) -> DTensor:
    """A plain tensor, the same on every rank, as a replicated ``DTensor``."""
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _leaf(x) -> bool:
    return isinstance(x, PartitionSpec)


# The local regions' FLOP counters, when a caller counts them apart (the
# dry-run: a ``FlopCounterMode`` sees a ``DTensor`` op at its global shape
# and a local region's ops at one rank's).
_REGION_FLOPS: contextvars.ContextVar = contextvars.ContextVar("region_flops", default=None)


def _region(fn, *args, **kwargs):
    """``fn`` on local tensors: a local region (its FLOPs collected when a
    ``count_region_flops`` context is open)."""
    found = _REGION_FLOPS.get()
    if found is None:
        return fn(*args, **kwargs)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    found.append(counter.get_total_flops())
    return out


@contextmanager
def count_region_flops():
    """Collect the FLOPs of every ``shard_map_compat`` body run inside the
    context (one rank's), as a list the context yields."""
    found: list = []
    token = _REGION_FLOPS.set(found)
    try:
        yield found
    finally:
        _REGION_FLOPS.reset(token)


def shard_map_compat(fn, *, mesh, in_specs, out_specs, manual, partial=()):
    """``fn`` over each rank's local shards (see the module docstring).
    ``in_specs``: one spec tree (or a spec standing for a whole subtree)
    per positional argument; ``out_specs`` likewise for the output, whose
    tensors are partial sums over the ``partial`` axes."""
    manual = set(manual)

    def restrict(spec):
        return PartitionSpec(*(tuple(a for a in entry_axes(e) if a in manual) or None
                               for e in spec))

    names = mesh.mesh_dim_names

    def out_placements(spec):
        return tuple(Partial() if name in partial else p
                     for p, name in zip(placements(restrict(spec), mesh), names))

    def run(*args):
        flat, tree = pytree.tree_flatten(args)
        specs = pytree._broadcast_to_and_flatten(tuple(in_specs), tree, is_leaf=_leaf)
        local = []
        for x, spec in zip(flat, specs):
            if not isinstance(x, torch.Tensor):
                local.append(x)
                continue
            if not isinstance(x, DTensor):
                x = replicated(x, mesh)
            pl = placements(restrict(spec), mesh)
            grad_pl = tuple(Partial() if isinstance(p, Replicate) and name in manual else p
                            for p, name in zip(pl, names))
            local.append(x.redistribute(mesh, pl).to_local(grad_placements=grad_pl))
        out = _region(fn, *pytree.tree_unflatten(local, tree))
        oflat, otree = pytree.tree_flatten(out)
        ospecs = pytree._broadcast_to_and_flatten(out_specs, otree, is_leaf=_leaf)
        wrapped = [
            DTensor.from_local(o, mesh, out_placements(s), run_check=False)
            if isinstance(o, torch.Tensor) else o
            for o, s in zip(oflat, ospecs)
        ]
        return pytree.tree_unflatten(wrapped, otree)

    return run


def local_heads(fn, inputs, *args, head_dims=None, **kwargs):
    """``fn(*inputs, *args, **kwargs)``, an attention function whose output
    has the queries' batch on dim 0 and their heads on dim 1.  On
    ``DTensor`` inputs it runs on each rank's (batch, head) shard, since
    attention is local to a batch row and a head: a mesh dim that splits
    any input on its batch dim (0), a cache among them, splits every
    input so (the others are cut to their rows, or moved there: never the
    cache gathered); one that splits every input that has heads on its
    head dim (``head_dims``, 1 for each by default; None for an input with
    no heads, as MLA's latent cache, which is then gathered) keeps that
    split, and a GQA group stays on one rank; every other mesh dim (a
    split sequence among them) is gathered first.  ``fn`` gets plain local
    tensors, and its output is placed by the splits kept.  On plain
    tensors ``fn`` runs as it is: this is the one place that knows the
    rule."""
    if not isinstance(inputs[0], DTensor):
        return fn(*inputs, *args, **kwargs)
    mesh = inputs[0].device_mesh
    heads = head_dims or (1,) * len(inputs)
    parts = [x.placements if isinstance(x, DTensor) else (Replicate(),) * mesh.ndim
             for x in inputs]
    keep, out_pl = [], []
    for here in zip(*parts):
        if any(p == Shard(0) for p in here):
            keep.append((Shard(0),) * len(inputs))
            out_pl.append(Shard(0))
        elif all(h is None or p == Shard(h) for p, h in zip(here, heads)):
            keep.append(tuple(Replicate() if h is None else Shard(h) for h in heads))
            out_pl.append(Shard(1))
        else:
            keep.append((Replicate(),) * len(inputs))
            out_pl.append(Replicate())

    def to_local(x, pl):
        if not isinstance(x, DTensor):
            x = replicated(x, mesh)
        # an input whole on a mesh dim whose ranks each run a part of the
        # output gets a part of its grad from each of them
        grad = tuple(Partial() if isinstance(p, Replicate) and isinstance(o, Shard) else p
                     for p, o in zip(pl, out_pl))
        return x.redistribute(mesh, pl).to_local(grad_placements=grad)

    local = [to_local(x, tuple(k[i] for k in keep)) for i, x in enumerate(inputs)]
    out = _region(fn, *local, *args, **kwargs)
    return DTensor.from_local(out, mesh, tuple(out_pl), run_check=False)


def batch_local(fn, params, *batched):
    """``fn(params, *batched)``; when ``batched[0]`` is a ``DTensor``, in a
    local region over the mesh axes that split its batch dim (dim 0):
    ``params`` whole on every rank (their grads summed over those axes),
    every tensor of ``batched`` (trees too) and of the output split on dim
    0 alike.  For per-row computations (a recurrence over time) whose ops
    ``DTensor`` would otherwise have to place one by one."""
    x = batched[0]
    if not isinstance(x, DTensor):
        return fn(params, *batched)
    mesh = x.device_mesh
    lead = tuple(name for name, pl in zip(mesh.mesh_dim_names, x.placements) if pl == Shard(0))
    rows = PartitionSpec(lead or None)
    region = shard_map_compat(fn, mesh=mesh, in_specs=(PartitionSpec(),) + (rows,) * len(batched),
                              out_specs=rows, manual=lead)
    return region(params, *batched)


def write_index(buf: torch.Tensor, dim: int, index: int, value: torch.Tensor) -> None:
    """``buf.select(dim, index).copy_(value)`` in place.  On a ``DTensor``
    ``buf`` only the rank whose shard holds ``index`` along ``dim`` writes,
    into its local shard, so the write lands in ``buf``'s own storage (a
    redistributed copy would not); ``value`` is first placed as ``buf``
    is, less ``dim``."""
    if not isinstance(buf, DTensor):
        buf.select(dim, index).copy_(value.to(buf.dtype))
        return
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = buf.device_mesh
    vpl = [Shard(p.dim - (p.dim > dim)) if isinstance(p, Shard) and p.dim != dim else Replicate()
           for p in buf.placements]
    if not isinstance(value, DTensor):
        value = replicated(value, mesh)
    local_value = value.redistribute(mesh, vpl).to_local()
    size, offset = compute_local_shape_and_global_offset(buf.shape, mesh, buf.placements)
    lo = offset[dim]
    if lo <= index < lo + size[dim]:
        buf.to_local().select(dim, index - lo).copy_(local_value.to(buf.dtype))
