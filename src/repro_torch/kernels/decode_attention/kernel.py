"""Launcher of the decode-attention CUDA kernel (``csrc/decode_attention.cu``):
split-KV flash-decoding, a partial pass over ``n_split`` column ranges per
(batch, kv head) and a combine pass."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

DECODE_ATTENTION = _lib.counter("decode_attention")
TILE = 32  # columns per tile in the kernel
TARGET_BLOCKS = 264  # about two partial blocks per SM of an H100 (132 SMs)
MAX_GROUP_WIDTH = 2048  # (H / KH) * D: at most 8 accumulators a thread
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # the kernel's instances


def split_plan(batch: int, kv_heads: int, kv_len: int):
    """``(n_split, chunk)``: ranges of ``chunk`` columns (a multiple of the
    tile) over the first ``kv_len``, sized so the grid has about
    ``TARGET_BLOCKS`` blocks and no range is empty."""
    want = max(1, -(-TARGET_BLOCKS // (batch * kv_heads)))
    chunk = -(-kv_len // want)
    chunk = -(-chunk // TILE) * TILE
    return -(-kv_len // chunk), chunk


def decode_attention_cuda(q, k, v, kv_len: int, sm_scale: float):
    """CUDA decode attention; see ``ref.decode_attention_ref``."""
    dev = q.device
    b, h, d = q.shape
    if k.dim() != 4:
        raise ValueError(f"k: expected (B, KH, S, D), got {tuple(k.shape)}")
    kh, s = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: dtype {q.dtype} not supported (float32, bfloat16)")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not supported {HEAD_DIMS}")
    if kh == 0 or h % kh:
        raise ValueError(f"decode_attention: {h} heads is not a multiple of {kh} kv heads")
    if (h // kh) * d > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention: group {h // kh} x head dim {d} exceeds {MAX_GROUP_WIDTH}")
    if not 1 <= kv_len <= s:
        raise ValueError(f"decode_attention: kv_len {kv_len} outside [1, {s}]")
    _lib.require(q, "q", q.dtype, (b, h, d), dev)
    _lib.require(k, "k", q.dtype, (b, kh, s, d), dev)
    _lib.require(v, "v", q.dtype, (b, kh, s, d), dev)
    n_split, chunk = split_plan(b, kh, kv_len)
    g = h // kh
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    part_m = torch.empty((b, kh, n_split, g), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, kh, n_split, g, d), dtype=torch.float32, device=dev)
    fn = _lib.bind(
        "decode_attention", "decode_attention_launch",
        [_lib.P] * 7 + [_lib.I32] * 9 + [_lib.F32, _lib.P],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), b, h, kh, s, d, int(kv_len), n_split,
        chunk, DTYPES[q.dtype], float(sm_scale), _lib.stream_of(dev),
    )
    _lib.check(err, "decode_attention")
    DECODE_ATTENTION.launched((q, k, v, dict(kv_len=int(kv_len), sm_scale=float(sm_scale))))
    return out
