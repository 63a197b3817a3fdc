from repro_torch.kernels.elim_combine.ops import elim_combine
from repro_torch.kernels.elim_combine.ref import elim_combine_ref

__all__ = ["elim_combine", "elim_combine_ref"]
