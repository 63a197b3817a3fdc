"""Carry state between the JAX package and the port through numpy.

Tree state: ``state_from_numpy`` takes a ``TreeState`` as a dict of numpy arrays (one
per field, ``stats`` itself a dict or NamedTuple of per-counter arrays), in
either the unstacked ``(N, ...)`` form of ``repro.core.ABTree.state`` or the
stacked ``(S, N, ...)`` form, and returns the port's stacked state on
``device``.  ``state_to_numpy`` goes the other way (stacked form).

Model parameters and decode caches: ``params_from_numpy`` takes the JAX
package's param tree as nested dicts of numpy arrays (stacked ``(L, …)``
layer leaves; a tied unembedding reads ``embed/tok``, so there is no second
copy to carry) and returns the same tree of tensors on ``device``;
``cache_from_numpy`` takes the decode cache (``{"layers": KVCache(k, v)}``
with numpy leaves, and ``"dense_layers"`` too for an MoE arch with dense
first layers; an MLA cache has ``v=None``; the recurrent families'
``SSMCache`` / ``XLSTMCache`` / ``SLSTMCache`` entries and whisper's bare
``enc_out`` array).  ``params_to_numpy`` / ``cache_to_numpy`` go the other
way.  ``opt_state_from_numpy`` / ``opt_state_to_numpy`` carry AdamW's
``OptState(m, v, count)`` (a NamedTuple or a dict of those fields), so a
JAX ``(params, OptState)`` crosses whole.  bfloat16 arrays
(``ml_dtypes.bfloat16``, as ``np.asarray`` gives them for JAX's bf16) cross
as their 16-bit patterns (``tensor_from_numpy`` / ``tensor_to_numpy``).

The caller converts the JAX arrays to numpy, so this module imports no JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.abtree import TreeState, TreeStats
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache
from repro_torch.models.xlstm import SLSTMCache, XLSTMCache
from repro_torch.optim.adamw import OptState

_DTYPES = dict(
    keys=torch.int64, vals=torch.int64, children=torch.int32, parent=torch.int32,
    pidx=torch.int32, is_leaf=torch.bool, size=torch.int32, level=torch.int32,
    ver=torch.int32, alloc=torch.bool, rec_key=torch.int64, rec_val=torch.int64,
    rec_ver=torch.int32, rec_op=torch.int32, root=torch.int32, height=torch.int32,
    dirty=torch.bool,
)


def _as_dict(x) -> Dict[str, np.ndarray]:
    return dict(x._asdict()) if hasattr(x, "_asdict") else dict(x)


def state_from_numpy(arrays, device="cpu") -> TreeState:
    """The port's stacked ``TreeState`` from per-field numpy arrays."""
    arrays = _as_dict(arrays)
    stacked = np.asarray(arrays["keys"]).ndim == 3

    def lift(a: np.ndarray) -> np.ndarray:
        a = np.asarray(a)
        return np.ascontiguousarray(a if stacked else a[None])

    fields = {
        name: torch.from_numpy(lift(np.array(arrays[name], dtype=_npdtype(dt)))).to(device)
        for name, dt in _DTYPES.items()
    }
    stats = _as_dict(arrays["stats"])
    fields["stats"] = TreeStats(
        **{
            name: torch.from_numpy(lift(np.array(stats[name], np.int64))).reshape(-1).to(device)
            for name in TreeStats._fields
        }
    )
    return TreeState(**fields)


def state_to_numpy(state: TreeState) -> Dict[str, object]:
    """Per-field numpy arrays of a stacked port state (``stats`` a dict)."""
    out: Dict[str, object] = {
        name: getattr(state, name).cpu().numpy() for name in _DTYPES
    }
    out["stats"] = {name: v.cpu().numpy() for name, v in state.stats._asdict().items()}
    return out


def _npdtype(dt: torch.dtype):
    return {
        torch.int64: np.int64, torch.int32: np.int32, torch.bool: np.bool_,
    }[dt]


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One array as a tensor on ``device``."""
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor as a numpy array: a copy, since the port updates caches
    in place."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only a bf16 tensor needs it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device="cpu"):
    """The port's param tree from the JAX package's, leaf for leaf."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_to_numpy(tree):
    """Nested dicts of numpy arrays from the port's param tree."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)


# the decode-cache kinds, by their field names
_CACHE_KINDS = {frozenset(t._fields): t for t in (KVCache, SSMCache, XLSTMCache, SLSTMCache)}


def cache_from_numpy(cache, device="cpu"):
    """The port's decode cache from the JAX package's: ``{name: entry}``,
    each entry a ``KVCache``, ``SSMCache``, ``XLSTMCache`` or
    ``SLSTMCache`` (a NamedTuple, or a dict of its fields) of numpy arrays,
    or a bare array (whisper's ``enc_out``)."""
    out = {}
    for name, entry in cache.items():
        if not (hasattr(entry, "_asdict") or isinstance(entry, dict)):
            out[name] = tensor_from_numpy(entry, device)
            continue
        parts = _as_dict(entry)
        kind = _CACHE_KINDS[frozenset(parts)]
        out[name] = kind(**{f: None if a is None else tensor_from_numpy(a, device)
                            for f, a in parts.items()})
    return out


def cache_to_numpy(cache):
    """``{name: {field: array}}`` from the port's decode cache (a bare
    tensor entry as a bare array)."""
    return {
        name: tensor_to_numpy(entry) if isinstance(entry, torch.Tensor) else
        {f: None if t is None else tensor_to_numpy(t) for f, t in entry._asdict().items()}
        for name, entry in cache.items()
    }


def opt_state_from_numpy(state, device="cpu") -> OptState:
    """The port's ``OptState`` from the JAX package's (``m`` and ``v`` param
    trees of numpy arrays, ``count`` a 0-d int32 array)."""
    parts = _as_dict(state)
    return OptState(
        m=params_from_numpy(parts["m"], device),
        v=params_from_numpy(parts["v"], device),
        count=tensor_from_numpy(parts["count"], device),
    )


def opt_state_to_numpy(state: OptState) -> Dict[str, object]:
    """``{"m": tree, "v": tree, "count": array}`` of numpy arrays."""
    return {"m": params_to_numpy(state.m), "v": params_to_numpy(state.v),
            "count": tensor_to_numpy(state.count)}
