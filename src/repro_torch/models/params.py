"""Parameter specs: one declaration drives initialization and the shapes
of the parameter tree (port of ``src/repro/models/params.py``).

Every parameter is declared as a ``P(shape, logical_axes, …)``.  Logical
axis names are mapped to mesh axes by a *rules* dict (MaxText style), so a
sharding strategy (TP only, FSDP×TP, EP, …) is data: ``param_shardings``
gives every leaf its ``NamedSharding`` under a rule set, replicating a dim
that the named axes do not divide.

Initialization draws each leaf from its own ``torch.Generator`` seeded from
a hash of the leaf's path, as the JAX package keys ``jax.random`` per path
(``_leaf_key``).  The two generators give different numbers from the same
seed, so the tests carry the JAX package's weights across
(``repro_torch.interop``) instead of comparing initializations.
"""
from __future__ import annotations

import hashlib
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._shardmap_compat import (
    NamedSharding,
    PartitionSpec,
    axis_sizes,
    check_unique,
    entry_axes,
)
from repro_torch.kernels._lib import resolve_device


class P(NamedTuple):
    """Parameter spec: shape + logical axes + init."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 0.02
    dtype: Any = torch.float32


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor that is made later (a cache leaf)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


# Default logical→physical rules.  ``fsdp`` variants additionally shard the
# non-contracting large dim over 'data' (ZeRO-3-equivalent).
RULES_TP = {
    "layers": None,
    "embed": None,
    "vocab": "model",
    "ffn": "model",
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",
    "experts": None,
    "expert_ffn": "model",
    "conv": None,
    "state": None,
}
RULES_FSDP_TP = dict(RULES_TP, embed="data")
# Expert parallelism: experts over 'model', expert-internal dims replicated.
RULES_EP = dict(RULES_TP, experts="model", expert_ffn=None)
RULES_EP_FSDP = dict(RULES_EP, embed="data")

RULE_SETS = {
    "tp": RULES_TP,
    "fsdp_tp": RULES_FSDP_TP,
    "ep": RULES_EP,
    "ep_fsdp": RULES_EP_FSDP,
}


def logical_to_pspec(axes, rules) -> PartitionSpec:
    return PartitionSpec(*(rules.get(ax) if ax is not None else None for ax in axes))


def _leaf_seed(path: str, seed: int) -> int:
    """The leaf's path hash (JAX's ``_leaf_key``), offset by ``seed``."""
    h = int.from_bytes(hashlib.sha256(path.encode()).digest()[:4], "little")
    return (h + seed * 0x9E3779B1) % (1 << 32)


def init_leaf(spec: P, path: str, device, seed: int = 0) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(path, seed))
    scale = spec.scale
    if spec.init == "embed":
        scale = 1.0 / np.sqrt(spec.shape[-1])
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(spec.dtype)


def is_spec(x) -> bool:
    return isinstance(x, P)


def _walk(tree, path=""):
    if is_spec(tree):
        yield path, tree
        return
    for k in sorted(tree.keys()):
        yield from _walk(tree[k], f"{path}/{k}")


def map_specs(fn, tree):
    """Apply fn(path, P) to every spec leaf, preserving structure."""

    def rec(t, path):
        if is_spec(t):
            return fn(path, t)
        return {k: rec(v, f"{path}/{k}") for k, v in t.items()}

    return rec(tree, "")


def init_params(spec_tree, device=None, seed: int = 0) -> dict:
    """Every leaf of ``spec_tree`` initialized on ``device`` (default the
    CUDA card; see the module docstring for the generators)."""
    device = resolve_device(device, "init_params")
    return map_specs(lambda p, s: init_leaf(s, p, device, seed), spec_tree)


def abstract_params(spec_tree) -> dict:
    """Every leaf of ``spec_tree`` as a tensor of its shape and dtype on the
    ``meta`` device: no storage (the dry-run's stand-ins, JAX's
    ``ShapeDtypeStruct``)."""
    return map_specs(lambda p, s: torch.empty(s.shape, dtype=s.dtype, device="meta"), spec_tree)


def param_shardings(spec_tree, mesh, rules) -> dict:
    """A ``NamedSharding`` a leaf of ``spec_tree`` under ``rules`` on
    ``mesh`` (a ``DeviceMesh`` or ``{axis: size}``); a dim whose axes do
    not divide it evenly is replicated.  A spec that maps one axis to two
    dims raises ``ValueError``, as JAX's ``NamedSharding`` does."""
    sizes = axis_sizes(mesh)

    def shard_one(path, s: P):
        fixed = []
        for dim, ax in zip(s.shape, logical_to_pspec(s.axes, rules)):
            size = int(np.prod([sizes[a] for a in entry_axes(ax)]))
            fixed.append(ax if ax is not None and dim % size == 0 else None)
        check_unique(fixed)
        return NamedSharding(mesh, PartitionSpec(*fixed))

    return map_specs(shard_one, spec_tree)


def count_params(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) for _, s in _walk(spec_tree))


def activation_sharding(mesh, *axes) -> NamedSharding:
    """The ``NamedSharding`` of an activation with the given spec entries."""
    return NamedSharding(mesh, PartitionSpec(*axes))
