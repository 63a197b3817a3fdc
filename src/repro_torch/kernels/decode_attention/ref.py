"""Plain PyTorch version of decode attention: a mirror of
``src/repro/kernels/decode_attention/ref.py``.  One query token per
sequence attends over a KV cache whose columns at or past ``kv_len`` are
masked; scores and the softmax are f32, the output is in q's dtype."""
from __future__ import annotations

from typing import Optional

import torch


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, KH, S, D)
    v: torch.Tensor,  # (B, KH, S, D)
    kv_len: Optional[int] = None,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    group = h // kh
    if sm_scale is None:
        sm_scale = 1.0 / (d**0.5)
    if kv_len is None:
        kv_len = s
    kx = torch.repeat_interleave(k, group, dim=1).float()
    vx = torch.repeat_interleave(v, group, dim=1).float()
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), kx) * sm_scale
    mask = torch.arange(s, device=q.device)[None, None, :] < kv_len
    scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vx).to(q.dtype)
