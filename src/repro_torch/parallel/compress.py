"""Gradient compression: per-block int8 quantization with error feedback
(port of the quantizers of ``src/repro/parallel/compress.py``).

The JAX module compresses the cross-pod hop of a hierarchical gradient
all-reduce: int8 payloads with one f32 scale per ``BLOCK`` values, and the
quantization residual carried into the next step (error feedback), so the
compression bias vanishes.  ``compressed_grad_reduce`` is that hop over a
mesh's pod axis: each rank quantizes its own contribution, the
dequantized f32 values are summed over the pod group
(``dist.all_reduce`` on ``mesh.get_group(pod_axis)``, JAX's ``psum``) and
divided by the number of pods.

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
import torch.distributed as dist
from torch.distributed.tensor import DTensor

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


def compressed_grad_reduce(grads, err, mesh, pod_axis: str = "pod"):
    """All-reduce ``grads`` over ``pod_axis`` of ``mesh`` with int8
    compression and error feedback.  grads / err: trees of equal structure
    (nested dicts of tensors), already reduced over the intra-pod data
    axis; this rank's contribution.  Returns (the mean over the pods, the
    new err).  A ``DTensor`` leaf is reduced through its local shard and
    returned placed as it came."""
    group = mesh.get_group(pod_axis)
    npods = mesh.size(mesh.mesh_dim_names.index(pod_axis))

    def reduce_leaf(g, e):
        local_g = g.to_local() if isinstance(g, DTensor) else g
        local_e = e.to_local() if isinstance(e, DTensor) else e
        q, scale, e_new = _ef_quantize(local_g, local_e)
        total = dequantize_int8(q, scale, local_g.shape, torch.float32)
        dist.all_reduce(total, group=group)
        out = (total / torch.tensor(float(npods), device=total.device)).to(local_g.dtype)
        if isinstance(g, DTensor):
            out = DTensor.from_local(out, g.device_mesh, g.placements, run_check=False)
        if isinstance(e, DTensor):
            e_new = DTensor.from_local(e_new, e.device_mesh, e.placements, run_check=False)
        return out, e_new

    pairs = tree_map(reduce_leaf, grads, err)
    first = lambda t: t[0] if isinstance(t, tuple) else {k: first(v) for k, v in t.items()}
    second = lambda t: t[1] if isinstance(t, tuple) else {k: second(v) for k, v in t.items()}
    return first(pairs), second(pairs)


def init_error_feedback(params):
    """Zero f32 residuals shaped like ``params`` (nested dicts of tensors)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
