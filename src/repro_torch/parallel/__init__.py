"""Parallel layer of the port (``src/repro/parallel/``): batch and cache
shardings, the int8 compressed gradient all-reduce, the GPipe stage loop
(``parallel.pipeline``) and the ambient mesh (``parallel.ctx``)."""
from repro_torch.parallel.sharding import (
    batch_pspecs,
    batch_shardings,
    cache_pspecs,
    cache_shardings,
)
from repro_torch.parallel.compress import (
    compressed_grad_reduce,
    dequantize_int8,
    quantize_int8,
)

__all__ = [
    "batch_pspecs",
    "batch_shardings",
    "cache_pspecs",
    "cache_shardings",
    "quantize_int8",
    "dequantize_int8",
    "compressed_grad_reduce",
]
