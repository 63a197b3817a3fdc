"""Public wrappers for the leaf probe: a CUDA tensor goes to the
hand-written kernel (``kernel.py``), which launches or raises; a CPU tensor
goes to the plain version (``ref.py``).  There is no fallback between the
two.

``leaf_probe_i64`` keeps the JAX package's API.  The JAX wrapper splits
64-bit keys into hi/lo int32 planes because the TPU has no int64 vectors;
the card compares int64 keys directly, with the same results."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.leaf_probe import kernel, ref


def leaf_probe(leaf_keys: torch.Tensor, leaf_vals: torch.Tensor, queries: torch.Tensor):
    """leaf_keys, leaf_vals: (B, b) gathered leaf rows (int32 or int64);
    queries: (B,) in the keys' dtype.  Returns ``(slot (B,) int32,
    val (B,))`` with slot -1 and val 0 where the query is absent."""
    if _lib.on_cuda(queries):
        return kernel.leaf_probe_cuda(leaf_keys, leaf_vals, queries)
    return ref.leaf_probe_ref(leaf_keys, leaf_vals, queries)


def leaf_probe_i64(leaf_keys64: torch.Tensor, leaf_vals32: torch.Tensor,
                   queries64: torch.Tensor):
    """Probe of 64-bit keys: a slot matches iff all 64 bits match.  Returns
    ``(slot, val)`` with slot -1 when absent."""
    if leaf_keys64.dtype != torch.int64 or queries64.dtype != torch.int64:
        raise TypeError("leaf_probe_i64: keys and queries must be int64")
    return leaf_probe(leaf_keys64, leaf_vals32, queries64)
