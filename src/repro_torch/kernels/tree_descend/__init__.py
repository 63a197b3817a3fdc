from repro_torch.kernels.tree_descend.ops import descend_probe, frontier_compact
from repro_torch.kernels.tree_descend.ref import (
    descend_probe_ref,
    descend_ref,
    frontier_compact_plain,
    frontier_compact_ref,
    probe_ref,
)

__all__ = [
    "descend_probe",
    "descend_probe_ref",
    "descend_ref",
    "frontier_compact",
    "frontier_compact_plain",
    "frontier_compact_ref",
    "probe_ref",
]
