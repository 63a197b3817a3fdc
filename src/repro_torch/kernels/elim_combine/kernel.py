"""Launcher of the elim_combine CUDA kernel (``csrc/elim_combine.cu``)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _lib

ELIM_COMBINE = _lib.counter("elim_combine")

# Tile states and counters of the decoupled look-back, one int64 buffer per
# device and stream.  Calls that share a buffer must not overlap in time, and
# calls on one stream never do; a CUDA graph launches on the buffer of the
# stream it was captured on.  The kernel leaves the buffer cleared for the
# next call, so it is zeroed only when it is allocated or grown.  A grown-out
# buffer is kept alive: a graph captured earlier still launches on it.
_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_OUTGROWN: List[torch.Tensor] = []


def _scratch(dev: torch.device, words: int) -> torch.Tensor:
    key = (dev, _lib.stream_of(dev))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"elim_combine: the look-back scratch of this stream must hold {words} "
                "words, which a CUDA graph cannot allocate; make one eager call at "
                "this width on the capture stream first"
            )
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(max(words, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int64, device=dev)
        _SCRATCH[key] = buf
    return buf


def tile_ops() -> int:
    """Ops one block of the CUDA kernel takes (its tile)."""
    return _lib.bind("elim_combine", "elim_combine_tile_ops", [])()


def elim_combine_cuda(ops, vals, seg_head, present0, val0):
    """CUDA segmented combine, one block per tile of ``tile_ops()`` ops with
    a decoupled look-back; see ``ref.elim_combine_ref``."""
    dev = ops.device
    s, b = ops.shape
    _lib.require(ops, "ops", torch.int32, (s, b), dev)
    _lib.require(vals, "vals", torch.int64, (s, b), dev)
    _lib.require(seg_head, "seg_head", torch.bool, (s, b), dev)
    _lib.require(present0, "present0", torch.bool, (s, b), dev)
    _lib.require(val0, "val0", torch.int64, (s, b), dev)
    before_p = torch.empty((s, b), dtype=torch.bool, device=dev)
    before_v = torch.empty((s, b), dtype=torch.int64, device=dev)
    after_p = torch.empty((s, b), dtype=torch.bool, device=dev)
    after_v = torch.empty((s, b), dtype=torch.int64, device=dev)
    words = _lib.bind("elim_combine", "elim_combine_scratch_words", [_lib.I32] * 2,
                      restype=_lib.I64)(s, b)
    scratch = _scratch(dev, words)
    fn = _lib.bind(
        "elim_combine", "elim_combine_launch",
        [_lib.P] * 9 + [_lib.I32] * 2 + [_lib.P, _lib.I64, _lib.P],
    )
    err = fn(
        ops.data_ptr(), vals.data_ptr(), seg_head.data_ptr(), present0.data_ptr(),
        val0.data_ptr(), before_p.data_ptr(), before_v.data_ptr(),
        after_p.data_ptr(), after_v.data_ptr(), s, b, scratch.data_ptr(), scratch.numel(),
        _lib.stream_of(dev),
    )
    _lib.check(err, "elim_combine")
    ELIM_COMBINE.launched((ops, vals, seg_head, present0, val0, {}))
    return before_p, before_v, after_p, after_v
