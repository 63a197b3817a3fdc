"""Parameter specs: one declaration drives initialization and the shapes
of the parameter tree (port of ``src/repro/models/params.py``).

Every parameter is declared as a ``P(shape, logical_axes, …)``.  The
logical axis names are kept for the sharding rules, which the port does not
apply yet (ROADMAP.md queue A, item 9).

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


def count_params(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) for _, s in _walk(spec_tree))
