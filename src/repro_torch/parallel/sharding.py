"""Input / KV-cache / state sharding policies per (arch family × shape)
(port of ``src/repro/parallel/sharding.py``).

Parameters are sharded by the logical-axis rules in models/params.py; this
module handles the *data* side:

  * training batches: batch dim over ('pod','data'),
  * KV caches: kv-heads over 'model' when divisible, otherwise the cache
    *sequence* dim over 'model' (sequence-sharded decode),
  * long-context (batch 1): sequence additionally over 'data' so 500k-token
    caches spread across the slice,
  * SSM/xLSTM recurrent states: heads over 'model' when divisible.

Every helper degrades to replication when a dim does not divide.  The
helpers read only axis sizes: ``mesh`` is a ``DeviceMesh`` or a ``{axis
name: size}`` mapping.  The long-context spec ``("model", "pod", "data")``
is JAX's; on a ``DeviceMesh`` its ``DTensor`` placements split the
sequence in mesh-dim order (``_shardmap_compat``'s docstring).
"""
from __future__ import annotations

import numpy as np

from repro_torch._shardmap_compat import NamedSharding, PartitionSpec, axis_sizes, entry_axes
from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig

PS = PartitionSpec


def _axsize(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in entry_axes(axes)]))


def _maybe(mesh, dim, axes):
    """axes if they divide dim, else None."""
    return axes if dim % _axsize(mesh, axes) == 0 else None


def data_axes(mesh):
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _tree_map(fn, tree):
    """``fn`` over the leaves of dicts, NamedTuples (a cache entry) and
    tuples; None stays None; a ``PartitionSpec``, a ``TensorSpec`` or
    anything with a shape is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, PartitionSpec) or hasattr(tree, "shape"):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return type(tree)(_tree_map(fn, v) for v in tree)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def batch_pspecs(cfg: ModelConfig, batch_tree, mesh):
    """PartitionSpec per input array: leading batch dim over (pod, data)."""
    da = data_axes(mesh)

    def assign(x):
        b = x.shape[0]
        lead = _maybe(mesh, b, da)
        return PS(lead, *([None] * (len(x.shape) - 1)))

    return _tree_map(assign, batch_tree)


def batch_shardings(cfg, batch_tree, mesh):
    return _tree_map(lambda s: NamedSharding(mesh, s), batch_pspecs(cfg, batch_tree, mesh))


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


def _kv_pspec(cfg, mesh, shape):
    """(L, B, KH, S, D) KV cache."""
    _, b, kh, s, _ = shape
    da = data_axes(mesh)
    bt = _maybe(mesh, b, da)
    if _maybe(mesh, kh, "model"):
        head_ax, seq_ax = "model", None
    else:
        head_ax, seq_ax = None, _maybe(mesh, s, "model")
    if bt is None:
        # long-context: spread the cache sequence across the data axes too
        seq_candidates = tuple(a for a in (seq_ax, *da) if a is not None)
        seq_ax = _maybe(mesh, s, seq_candidates) if seq_candidates else None
    return PS(None, bt, head_ax, seq_ax, None)


def _mla_pspec(cfg, mesh, shape):
    """(L, B, S, C) latent cache."""
    _, b, s, _ = shape
    da = data_axes(mesh)
    bt = _maybe(mesh, b, da)
    seq_ax = _maybe(mesh, s, "model")
    if bt is None:
        seq_candidates = tuple(a for a in (seq_ax, *da) if a is not None)
        seq_ax = _maybe(mesh, s, seq_candidates) if seq_candidates else None
    return PS(None, bt, seq_ax, None)


def _state_pspec(cfg, mesh, shape):
    """(L, B, H, ...) recurrent state: batch then heads."""
    b = shape[1]
    da = data_axes(mesh)
    bt = _maybe(mesh, b, da)
    rest = [None] * (len(shape) - 2)
    if len(shape) > 2:
        h = shape[2]
        rest[0] = _maybe(mesh, h, "model")
    return PS(None, bt, *rest)


def cache_pspecs(cfg: ModelConfig, batch: int, s_max: int, mesh):
    spec = backbone.cache_spec(cfg, batch, s_max)

    def assign(x):
        shape = x.shape
        if len(shape) == 5 and shape[3] == s_max:  # (L,B,KH,S,D)
            return _kv_pspec(cfg, mesh, shape)
        if len(shape) == 4 and cfg.attn == "mla" and shape[2] == s_max:
            return _mla_pspec(cfg, mesh, shape)
        if len(shape) == 3 and shape[1] == cfg.enc_frames and cfg.family == "audio":
            da = data_axes(mesh)
            return PS(_maybe(mesh, shape[0], da), None, None)
        return _state_pspec(cfg, mesh, shape)

    return _tree_map(assign, spec)


def cache_shardings(cfg, batch, s_max, mesh):
    return _tree_map(lambda s: NamedSharding(mesh, s), cache_pspecs(cfg, batch, s_max, mesh))
