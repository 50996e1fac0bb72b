"""Band stencils the cuda backend generates: their PyTorch oracles."""
from .ref import heat_3d, jacobi_2d

__all__ = ["heat_3d", "jacobi_2d"]
