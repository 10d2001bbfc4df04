from repro_torch.kernels.stencil27.stencil27 import stencil27
from repro_torch.kernels.stencil27.ops import stencil_update
from repro_torch.kernels.stencil27.ref import jacobi_weights, stencil27_ref

__all__ = ["stencil27", "stencil_update", "stencil27_ref", "jacobi_weights"]
