"""Plain PyTorch version of flash attention: a mirror of
``src/repro/kernels/flash_attention/ref.py`` (GQA, causal, sliding window).
Scores and the softmax are f32, masked entries hold -1e30, and the output
is cast back to q's dtype.  Its autograd is the port's backward pass, as
the VJP of the JAX reference is the JAX package's."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KH, S, D)
    v: torch.Tensor,  # (B, KH, S, D)
    *,
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    b, h, s, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    group = h // kh
    if sm_scale is None:
        sm_scale = 1.0 / (d**0.5)
    kx = torch.repeat_interleave(k, group, dim=1)
    vx = torch.repeat_interleave(v, group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) * sm_scale
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    scores = scores.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx.float())
    return out.to(q.dtype)
