"""Roofline terms of the port's dry-run records, on the NVIDIA H100 80GB
HBM3 (SXM, 700 W) (port of ``src/repro/analysis/roofline.py``, whose
constants are a TPU v5e's).

Three terms per (arch × shape × mesh) cell, per device:

    compute    = FLOPs                / peak bf16 FLOP/s
    memory     = bytes accessed       / HBM bytes/s
    collective = collective operand bytes / NVLink bytes/s

The FLOPs and the collective bytes are counted on meta tensors by the
dry-run: ``torch.utils.flop_counter.FlopCounterMode`` for the FLOPs, and
``CollectiveRecorder`` below (a ``CommDebugMode`` that also keeps each
collective's operand bytes) for the collectives ``DTensor`` issues; they
are counts, not times.  ``collective_bytes`` takes the place of JAX's
``collective_bytes_from_hlo``, with its keys.

A trace counts only the step's own ops.  ``DTensor`` derives the output
shape of each op it has not met before by running the op once more on fake
global-shape tensors, which every dispatch mode sees like the step's ops,
and caches what it derived (in C++ and in Python) for the rest of the
process: counted, those runs made a process's first trace of a cell read
more FLOPs than its second.  ``ColdShardingPropagation`` empties
the caches and marks the propagation while it runs; ``StepFlops`` and
``PeakMemory`` leave its ops out.  So a cell's counts are the same in a
fresh process, after other traces in the same process and under any
``PYTHONHASHSEED``; they do depend on the torch version, whose ``DTensor``
strategies choose other collectives.
"""
from __future__ import annotations

import functools
import weakref
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

# --- NVIDIA H100 80GB HBM3, SXM, 700 W (NVIDIA's data sheet, dense rates) ---
PEAK_FLOPS = 989e12  # bf16 on the tensor cores
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s one way (900 GB/s NVLink 4 total, both ways)
HBM_BYTES = 80e9  # device memory

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# the c10d functional collectives DTensor issues, and the c10d ops that
# torch.distributed's own calls reach, by the HLO opcode JAX's tally uses
_OP_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


class CollectiveRecorder(CommDebugMode):
    """``CommDebugMode`` that also records, for every collective it sees,
    its kind (JAX's opcode names) and one rank's operand bytes (the first
    argument: the local shard sent or reduced)."""

    def __init__(self):
        super().__init__()
        self.records = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and not isinstance(func, torch._ops.HigherOrderOperator):
            kind = _OP_NAMES.get(func._overloadpacket.__name__)
            if kind is not None:
                self.records.append((kind, _tensor_bytes(args[0]) if args else 0))
        return out


def _clear_sharding_caches(prop) -> None:
    torch._C._clear_DTensor_sharding_propagator_cache()
    prop.propagate_op_sharding.cache_clear()
    type(prop)._propagate_tensor_meta_cached.cache_clear()


class ColdShardingPropagation:
    """While open, ``DTensor``'s sharding propagation starts from empty
    caches, and ``running`` counts the propagations under way (see the
    module docstring); the counters given this object skip their ops.  The
    caches are emptied again on exit."""

    def __init__(self):
        self.running = 0
        self._prop = DTensor._op_dispatcher.sharding_propagator
        self._cached = None

    def _marked(self, fn):
        def run(*args, **kwargs):
            self.running += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.running -= 1
        return run

    def __enter__(self):
        prop, cls = self._prop, type(self._prop)
        self._cached = prop.propagate_op_sharding
        _clear_sharding_caches(prop)
        # instance attributes, this propagator only; the Python cache wraps
        # the marked propagation for the duration
        prop.propagate_op_sharding_non_cached = self._marked(
            cls.propagate_op_sharding_non_cached.__get__(prop))
        prop._propagate_tensor_meta_non_cached = self._marked(
            cls._propagate_tensor_meta_non_cached.__get__(prop))
        prop.propagate_op_sharding = functools.lru_cache(None)(prop.propagate_op_sharding_non_cached)
        return self

    def __exit__(self, *exc):
        prop = self._prop
        del prop.propagate_op_sharding_non_cached, prop._propagate_tensor_meta_non_cached
        prop.propagate_op_sharding = self._cached
        _clear_sharding_caches(prop)
        return False


class StepFlops(FlopCounterMode):
    """``FlopCounterMode`` that leaves out the ops ``DTensor``'s sharding
    propagation runs while ``propagation`` (a ``ColdShardingPropagation``)
    is open."""

    def __init__(self, propagation: ColdShardingPropagation, **kwargs):
        super().__init__(**kwargs)
        self.propagation = propagation

    def _count_flops(self, func_packet, out, args, kwargs):
        if self.propagation.running:
            return out
        return super()._count_flops(func_packet, out, args, kwargs)


class PeakMemory(TorchDispatchMode):
    """The peak bytes of the storages that a step's ops make and hold at
    once, one rank's (``DTensor`` runs its ops on the local shards, which
    is what a mode sees); a view counts the storage it shares, and a
    storage is freed with the tensor that brought it.  What ``DTensor``'s
    sharding propagation makes while ``propagation`` is open is left out:
    it runs each new op once on global-shape fake tensors, which hold no
    memory (``MemTracker`` counts them on the card's torch 2.11, where a
    436 GB placeholder of deepseek's stacked experts read as a decode
    step's temp)."""

    def __init__(self, propagation: ColdShardingPropagation):
        super().__init__()
        self.propagation = propagation
        self.live: Dict[int, int] = {}
        self.now = 0
        self.peak = 0

    def _free(self, key):
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.propagation.running:
            return out
        for o in pytree.tree_leaves(out):
            if not isinstance(o, torch.Tensor):
                continue
            storage = o.untyped_storage()
            key = storage._cdata
            if key in self.live:
                continue
            self.live[key] = storage.nbytes()
            self.now += self.live[key]
            weakref.finalize(o, self._free, key)
        self.peak = max(self.peak, self.now)
        return out


def collective_bytes(records) -> Dict:
    """Per-device operand bytes and counts per collective kind, from
    ``CollectiveRecorder.records``."""
    out = {op: 0 for op in _COLLECTIVES}
    counts = {op: 0 for op in _COLLECTIVES}
    for kind, nbytes in records:
        out[kind] += int(nbytes)
        counts[kind] += 1
    return {
        "per_op_bytes": out,
        "per_op_count": counts,
        "total_bytes": int(sum(out.values())),
    }


def _prod(t):
    n = 1
    for x in t:
        n *= x
    return n


def active_params(cfg) -> float:
    """Parameters touched per token: total minus unselected routed experts
    (expert tensors are stacked (L, E, …) — detect by the E dim)."""
    from repro_torch.models import backbone
    from repro_torch.models.params import _walk, count_params

    spec = backbone.model_spec(cfg)
    total = count_params(spec)
    if not cfg.n_experts:
        return float(total)
    routed = 0
    for path, s in _walk(spec):
        if "/ffn/" in path and "shared" not in path and "router" not in path:
            if cfg.n_experts in s.shape:
                routed += int(_prod(s.shape))
    return float(total - routed + routed * cfg.top_k / cfg.n_experts)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE), D = tokens."""
    active = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * active * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * active * shape.batch * shape.seq
    # decode: one token per sequence
    return 2.0 * active * shape.batch


def analytic_memory_bytes(cfg, shape) -> float:
    """First-principles per-step HBM traffic floor (global): params read
    once (bf16) + decode cache streamed once + activations written / read
    once per layer."""
    p_bytes = 2.0 * active_params(cfg)
    if shape.kind == "decode":
        cache = 0.0
        if cfg.attn == "mla":
            cache = cfg.n_layers * shape.batch * shape.seq * (cfg.kv_lora + cfg.rope_head) * 2.0
        elif cfg.family in ("dense", "moe", "vlm", "audio"):
            kv_layers = cfg.n_layers
            cache = kv_layers * shape.batch * cfg.n_kv * shape.seq * cfg.d_head * 2 * 2.0
            if cfg.window:
                cache = (kv_layers * shape.batch * cfg.n_kv * min(cfg.window, shape.seq)
                         * cfg.d_head * 2 * 2.0)
        elif cfg.family == "hybrid":
            n_inv = cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0
            cache = n_inv * shape.batch * cfg.n_kv * shape.seq * cfg.d_head * 2 * 2.0
        return p_bytes + cache
    tokens = shape.batch * shape.seq
    act = 2.0 * tokens * cfg.d_model * cfg.n_layers * (4 if shape.kind == "train" else 2)
    return p_bytes + act


def roofline_terms(rec: dict) -> Dict:
    """rec: one dry-run cell record → the three terms in seconds, per
    device (the record's FLOPs, bytes and collective bytes are one
    device's)."""
    t_compute = rec["cost"]["flops"] / PEAK_FLOPS
    t_memory = rec["cost"]["bytes_accessed"] / HBM_BW
    t_collective = rec["collectives"]["total_bytes"] / NVLINK_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "chips": rec["n_devices"],
    }
