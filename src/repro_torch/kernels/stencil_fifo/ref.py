"""PyTorch oracle for the FIFO-streamed Jacobi-1D stencil kernel.

Semantics: T steps of  a[i] ← (a[i-1] + a[i] + a[i+1]) / 3  with zero
(Dirichlet) boundaries — the paper's motivating kernel (Fig. 1) with the
load/store processes at the array ends.  The same formula, in the same
order, as `repro.kernels.stencil_fifo.ref.jacobi_1d`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def jacobi_1d(a0: torch.Tensor, steps: int) -> torch.Tensor:
    a = a0.to(torch.float32)
    for _ in range(steps):
        p = F.pad(a, (1, 1))
        a = (p[:-2] + a + p[2:]) / 3.0
    return a.to(a0.dtype)
