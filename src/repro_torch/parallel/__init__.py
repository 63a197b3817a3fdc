"""Parallel layer of the port: so far the gradient quantizers of
``src/repro/parallel/compress.py``.  The mesh, the shardings and the
compressed all-reduce wait for ROADMAP.md queue A, item 9."""
from repro_torch.parallel.compress import (
    compressed_grad_reduce,
    dequantize_int8,
    quantize_int8,
)

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "compressed_grad_reduce",
]
