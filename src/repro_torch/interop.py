"""Carry tree state between the JAX package and the port through numpy.

``state_from_numpy`` takes a ``TreeState`` as a dict of numpy arrays (one
per field, ``stats`` itself a dict or NamedTuple of per-counter arrays), in
either the unstacked ``(N, ...)`` form of ``repro.core.ABTree.state`` or the
stacked ``(S, N, ...)`` form, and returns the port's stacked state on
``device``.  ``state_to_numpy`` goes the other way (stacked form).  The
caller converts the JAX arrays to numpy, so this module imports no JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.abtree import TreeState, TreeStats

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
