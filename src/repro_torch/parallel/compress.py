"""Gradient compression: per-block int8 quantization with error feedback
(port of the quantizers of ``src/repro/parallel/compress.py``).

The JAX module compresses the cross-pod hop of a hierarchical gradient
all-reduce: int8 payloads with one f32 scale per ``BLOCK`` values, and the
quantization residual carried into the next step (error feedback), so the
compression bias vanishes.  The quantizers are ported here; the reduction
itself (``compressed_grad_reduce``, a ``shard_map`` over the pod axis)
needs the parallel layer and raises until it lands (ROADMAP.md queue A,
item 9).

``torch.round`` and ``jnp.round`` both round half to even, and every
quotient is a true f32 division as JAX's (never a product with a
reciprocal, which PyTorch's CUDA kernels use for a Python-number divisor),
so ``q`` and ``scale`` are those of the JAX package bit for bit, on the
card as on the CPU.  All of this is plain PyTorch: the JAX
module is plain ``jnp``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim.adamw import tree_map

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of ``x`` (any shape).
    Returns (q (N, BLOCK) int8, scale (N, 1) f32)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    # a tensor divisor: CUDA divides by a Python number as a product with
    # its reciprocal, which can differ from the quotient in the last bit
    scale = blocks.abs().amax(dim=1, keepdim=True) / torch.tensor(127.0, device=x.device)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    out = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return out[:n].reshape(shape).to(dtype)


def _ef_quantize(x, err):
    """Quantize x + err; return (q, scale, new_err)."""
    target = x + err
    q, scale = quantize_int8(target)
    deq = dequantize_int8(q, scale, x.shape, x.dtype)
    return q, scale, target - deq


def compressed_grad_reduce(grads, err, mesh=None, pod_axis: str = "pod"):
    """The int8 all-reduce over the pod axis of a mesh: not ported yet."""
    raise NotImplementedError(
        "compressed_grad_reduce needs a mesh, which is not ported yet (ROADMAP.md queue A, "
        "item 9: parallelism); quantize_int8, dequantize_int8 and _ef_quantize are"
    )


def init_error_feedback(params):
    """Zero f32 residuals shaped like ``params`` (nested dicts of tensors)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
