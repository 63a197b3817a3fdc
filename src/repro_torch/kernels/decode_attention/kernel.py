"""Launcher of the decode-attention CUDA kernel (``csrc/decode_attention.cu``):
one launch, a thread-block cluster per (batch, kv head) whose blocks split
the first ``kv_len`` columns and merge their partials through distributed
shared memory."""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import _lib

DECODE_ATTENTION = _lib.counter("decode_attention")
MAX_CLUSTER = 8  # the portable cluster size
MIN_COLUMNS = 16  # fewer columns a block are not worth a block of their own
MAX_GROUP_WIDTH = 2048  # (H / KH) * D: the kernel's shared-memory sizing
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # the kernel's instances


def cluster_plan(batch: int, kv_heads: int, kv_len: int,
                 capacity: Callable[[int], int]) -> Tuple[int, int]:
    """``(n_blocks, chunk)``: the cluster of each (batch, kv head) has
    ``n_blocks`` <= ``MAX_CLUSTER`` blocks, block r covering columns
    ``[r * chunk, min((r + 1) * chunk, kv_len))``; no block is empty and
    every column below ``kv_len`` is covered once.  ``capacity(n)`` is how
    many clusters of n blocks the card holds at once (``cluster_capacity``):
    the grid aims at ``capacity(1)`` blocks, as many as run at once, and
    clusters shrink until all ``batch * kv_heads`` of them run together (a
    second wave of clusters would double the call)."""
    n_clusters = batch * kv_heads
    want = max(1, -(-capacity(1) // n_clusters))
    n = min(MAX_CLUSTER, want, -(-kv_len // MIN_COLUMNS))
    while n > 1 and capacity(n) < n_clusters:
        n -= 1
    chunk = -(-kv_len // n)
    return -(-kv_len // chunk), chunk


_CAPACITY: Dict[Tuple[int, int, int], Dict[int, int]] = {}


def cluster_capacity(dtype: torch.dtype, head_dim: int, group: int) -> Callable[[int], int]:
    """The card's ``capacity`` for ``cluster_plan``: clusters of n blocks of
    the kernel's instance that fit at once, asked of the CUDA runtime once
    per (dtype, head dim, group)."""
    key = (DTYPES[dtype], head_dim, group)
    caps = _CAPACITY.get(key)
    if caps is None:
        fn = _lib.bind("decode_attention", "decode_attention_capacity",
                       [_lib.I32] * 4 + [ctypes.POINTER(ctypes.c_int)])
        caps = {}
        for n in range(1, MAX_CLUSTER + 1):
            out = ctypes.c_int(0)
            _lib.check(fn(head_dim, key[0], group, n, ctypes.byref(out)), "decode_attention")
            caps[n] = out.value
        _CAPACITY[key] = caps
    return caps.__getitem__


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
    q, k, v = (_lib.aligned16(x) for x in (q, k, v))
    n_blocks, chunk = cluster_plan(b, kh, kv_len, cluster_capacity(q.dtype, d, h // kh))
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    fn = _lib.bind(
        "decode_attention", "decode_attention_launch",
        [_lib.P] * 4 + [_lib.I32] * 9 + [_lib.F32, _lib.P],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kh, s, d, int(kv_len),
        n_blocks, chunk, DTYPES[q.dtype], float(sm_scale), _lib.stream_of(dev),
    )
    _lib.check(err, "decode_attention")
    DECODE_ATTENTION.launched((q, k, v, dict(kv_len=int(kv_len), sm_scale=float(sm_scale))))
    return out
