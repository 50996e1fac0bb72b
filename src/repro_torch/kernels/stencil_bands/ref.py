"""PyTorch oracles for the band stencils the cuda backend generates.

Same conventions as `stencil_fifo/ref.py`: every cell updates every step,
with zero (Dirichlet) values outside the array.  The formulas, and the
order of their operations, are those of `repro.kernels.stencil_bands.ref`
and of `runtime.cuda_codegen.STENCIL_PROGRAMS`; pads and slices only, no
convolution (a float32 convolution may run in TF32 on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def jacobi_2d(a0: torch.Tensor, steps: int) -> torch.Tensor:
    """T steps of the 5-point average
    a[i,j] ← (a[i,j] + a[i,j−1] + a[i,j+1] + a[i−1,j] + a[i+1,j]) / 5."""
    a = a0.to(torch.float32)
    for _ in range(steps):
        p = F.pad(a, (1, 1, 1, 1))
        a = (p[1:-1, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
             + p[:-2, 1:-1] + p[2:, 1:-1]) / 5.0
    return a.to(a0.dtype)


def heat_3d(a0: torch.Tensor, steps: int) -> torch.Tensor:
    """T steps of the 7-point heat update
    a ← a + 0.125·(∂²ᵢ + ∂²ⱼ + ∂²ₖ), each ∂² the central second difference."""
    a = a0.to(torch.float32)
    for _ in range(steps):
        p = F.pad(a, (1, 1, 1, 1, 1, 1))
        c = p[1:-1, 1:-1, 1:-1]
        a = (c
             + 0.125 * (p[:-2, 1:-1, 1:-1] - 2.0 * c + p[2:, 1:-1, 1:-1])
             + 0.125 * (p[1:-1, :-2, 1:-1] - 2.0 * c + p[1:-1, 2:, 1:-1])
             + 0.125 * (p[1:-1, 1:-1, :-2] - 2.0 * c + p[1:-1, 1:-1, 2:]))
    return a.to(a0.dtype)
