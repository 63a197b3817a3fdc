"""EmbedElim: publishing elimination applied to sparse embedding updates
(port of ``src/repro/optim/sparse.py``).

Zipfian token frequency makes embedding-row gradient updates a skewed
update-heavy dictionary workload, the paper's target profile.  In the OCC
analog every (token, grad) pair scatters its own row update (duplicate rows
rewritten k times); elimination combines duplicates first, so each hot row
is written once per batch.  The combine is a stable sort and a segment sum:
the key-sorted segmented structure of ``core/elimination.py`` (and the
elim_combine kernel), with "insert(v)" generalized to "accumulate(v)".

Both functions are plain PyTorch, as the JAX functions are plain ``jnp``.
On a CUDA tensor ``index_add_`` adds a row's duplicates with atomics in an
undefined order, so the two results agree within the summation-order bound
of their f32 sums, not bit for bit.  The statistics are exact integers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SparseUpdateStats(NamedTuple):
    writes_occ: torch.Tensor  # () int32: rows written without elimination (= #tokens)
    writes_elim: torch.Tensor  # () int32: rows written with elimination (= #unique)
    eliminated: torch.Tensor  # () int32


def embed_elim_update(
    table: torch.Tensor,  # (V, D)
    token_ids: torch.Tensor,  # (T,)
    row_grads: torch.Tensor,  # (T, D)
    lr: float,
):
    """Combine duplicate-row grads (stable sort + segment sum), then write
    each unique row once.  Returns (the new table, SparseUpdateStats)."""
    t = token_ids.shape[0]
    v, d = table.shape
    order = torch.sort(token_ids, stable=True).indices
    ids_s = token_ids[order].long()
    grads_s = row_grads[order]
    seg_head = torch.ones_like(ids_s, dtype=torch.bool)
    seg_head[1:] = ids_s[1:] != ids_s[:-1]
    seg_id = torch.cumsum(seg_head, 0) - 1
    combined = torch.zeros((t, d), dtype=grads_s.dtype, device=grads_s.device)
    combined.index_add_(0, seg_id, grads_s)  # (T, D), segments past n_unique stay 0
    # the row of each segment (every element of a segment shares it); the
    # segments past n_unique keep the sentinel row V, dropped below
    seg_rows = torch.full((t,), v, dtype=torch.long, device=ids_s.device)
    seg_rows.scatter_reduce_(0, seg_id, ids_s, reduce="amin")
    padded = torch.empty((v + 1, d), dtype=table.dtype, device=table.device)
    padded[:v] = table
    padded[v] = 0
    padded.index_add_(0, seg_rows, (-lr * combined).to(table.dtype))
    n_unique = seg_head.sum(dtype=torch.int32)
    stats = SparseUpdateStats(
        writes_occ=torch.tensor(t, dtype=torch.int32, device=n_unique.device),
        writes_elim=n_unique,
        eliminated=t - n_unique,
    )
    return padded[:v], stats


def embed_occ_update(table, token_ids, row_grads, lr):
    """OCC analog: scatter every pair individually (duplicate rows written
    multiple times).  The same sum; physically k times the writes."""
    return table.index_add(0, token_ids.long(), (-lr * row_grads).to(table.dtype))
