"""Launcher of the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``): one block per (query tile, batch·head)
walks the key tiles its rows can see, with an f32 online softmax; bf16 on
the tensor cores (wgmma, fed by TMA), float32 on the CUDA cores."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

FLASH_ATTENTION = _lib.counter("flash_attention")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)  # the kernel's instances


def flash_attention_cuda(q, k, v, *, causal: bool, window: int, sm_scale: float):
    """CUDA flash-attention forward; see ``ref.attention_ref``.  Returns
    (B, H, S, D) in q's dtype."""
    dev = q.device
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: expected q (B, H, S, D) and k/v (B, KH, S, D), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    b, h, s, d = q.shape
    kh = k.shape[1]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported (float32, bfloat16)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not supported {HEAD_DIMS}")
    if kh == 0 or h % kh:
        raise ValueError(f"flash_attention: {h} heads is not a multiple of {kh} kv heads")
    if s < 1:
        raise ValueError("flash_attention: empty sequence")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    _lib.require(q, "q", q.dtype, (b, h, s, d), dev)
    _lib.require(k, "k", q.dtype, (b, kh, s, d), dev)
    _lib.require(v, "v", q.dtype, (b, kh, s, d), dev)
    q, k, v = (_lib.aligned16(x) for x in (q, k, v))
    out = torch.empty_like(q)
    fn = _lib.bind(
        "flash_attention", "flash_attention_launch",
        [_lib.P] * 4 + [_lib.I32] * 8 + [_lib.F32, _lib.P],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kh, s, d,
        int(bool(causal)), int(window), DTYPES[q.dtype], float(sm_scale),
        _lib.stream_of(dev),
    )
    _lib.check(err, "flash_attention")
    FLASH_ATTENTION.launched(
        (q, k, v, dict(causal=bool(causal), window=int(window), sm_scale=float(sm_scale)))
    )
    return out
