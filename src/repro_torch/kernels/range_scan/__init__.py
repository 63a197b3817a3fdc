from repro_torch.kernels.range_scan.ops import range_scan
from repro_torch.kernels.range_scan.ref import range_scan_ref

__all__ = ["range_scan", "range_scan_ref"]
