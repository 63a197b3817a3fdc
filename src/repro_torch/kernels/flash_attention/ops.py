"""Public wrapper for flash attention.

On CUDA tensors it is a ``torch.autograd.Function``: the forward launches
the hand-written kernel (``kernel.py``) and saves q, k and v; the backward
recomputes through the plain version (``ref.attention_ref``) and returns
its autograd gradients.  That is the JAX package's ``custom_vjp``
(``src/repro/kernels/flash_attention/ops.py``): a kernel forward and the
reference's VJP, with no backward kernel.  On CPU tensors it is the plain
version with ordinary autograd.  There is no fallback between the two.

``DTensor`` inputs (a model under a mesh) are never handed to either: the
wrapper runs again on each rank's local (batch, head) shard
(``_shardmap_compat.local_heads``), whose plain tensors then take the
rule above."""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch._shardmap_compat import local_heads
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention import kernel, ref


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, sm_scale=sm_scale)
        return kernel.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                           sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = tuple(x.detach().requires_grad_() for x in (q, k, v))
            out = ref.attention_ref(*inputs, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, inputs, g)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KH, S, D)
    v: torch.Tensor,  # (B, KH, S, D)
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention, causal or not, with an optional sliding window
    (``window > 0``: a key column is seen by rows less than ``window``
    after it).  Returns (B, H, S, D) in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if isinstance(q, DTensor):
        return local_heads(flash_attention, (q, k, v), causal, window, sm_scale)
    if _lib.on_cuda(q):
        return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                     bool(causal), int(window), float(sm_scale))
    return ref.attention_ref(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
