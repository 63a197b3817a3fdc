from repro_torch.kernels.range_scan.kernel import MAX_CAP
from repro_torch.kernels.range_scan.ops import range_scan
from repro_torch.kernels.range_scan.ref import range_scan_ref

__all__ = ["MAX_CAP", "range_scan", "range_scan_ref"]
