"""Public wrapper for decode attention: a CUDA tensor goes to the
hand-written kernel (``kernel.py``), which launches or raises; a CPU tensor
goes to the plain version (``ref.py``).  There is no fallback between the
two.  A ``DTensor`` input (a model under a mesh) reaches neither: the
wrapper runs again on each rank's local (batch, head) shard, its cache's
sequence gathered whole (``_shardmap_compat.local_heads``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch._shardmap_compat import local_heads
from repro_torch.kernels import _lib
from repro_torch.kernels.decode_attention import kernel, ref


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, KH, S, D)
    v: torch.Tensor,  # (B, KH, S, D)
    kv_len: Optional[int] = None,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA decode attention of one query token per sequence over the first
    ``kv_len`` cached columns (a host int, default S).  Returns (B, H, D) in
    q's dtype."""
    if kv_len is None:
        kv_len = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if isinstance(q, DTensor):
        return local_heads(decode_attention, (q, k, v), kv_len, sm_scale=sm_scale)
    if _lib.on_cuda(q):
        return kernel.decode_attention_cuda(q, k, v, int(kv_len), sm_scale)
    return ref.decode_attention_ref(q, k, v, kv_len, sm_scale=sm_scale)
