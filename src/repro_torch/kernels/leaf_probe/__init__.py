from repro_torch.kernels.leaf_probe.ops import leaf_probe, leaf_probe_i64
from repro_torch.kernels.leaf_probe.ref import leaf_probe_ref

__all__ = ["leaf_probe", "leaf_probe_i64", "leaf_probe_ref"]
