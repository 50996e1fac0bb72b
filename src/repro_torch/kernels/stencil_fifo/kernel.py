"""The hand-written Fig. 3 jacobi-1d: time-tiled, with the paper's FIFO
channels carried from one block to the next.

The port of `repro.kernels.stencil_fifo.kernel`.  The iteration space is
tiled into parallelograms (skew one cell a step); the dependences crossing
a tile boundary — the channels the paper's SPLIT isolates at each depth —
become a ``(steps+1) × 2`` FIFO that block ``j`` fills with its trailing
two cells at every time level and block ``j+1`` reads.  In-tile
dependences never leave the kernel, so device-memory traffic is one read
and one write of the array instead of ``steps`` round trips.

The time tile equals the block (``steps == block``), so block ``j``'s
final row is output block ``j − 1``: its output is aligned with its input,
and an extra all-zero grid step flushes the last block.  Boundaries are
Dirichlet zero, as in `ref.jacobi_1d`.

`jacobi_fifo` runs ``csrc/stencil_fifo.cu`` on a CUDA tensor and
`_jacobi_fifo_plain` on a CPU one.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib


def _check(n: int, steps: int, block: int) -> None:
    if steps != block or block < 1 or n % block:
        raise ValueError(f"jacobi_fifo needs steps == block and "
                         f"N % block == 0, got N={n}, steps={steps}, "
                         f"block={block}")


def _jacobi_fifo_plain(x: torch.Tensor, steps: int,
                       block: int) -> torch.Tensor:
    """The plain PyTorch version: the Pallas grid walked in order, with the
    two FIFO copies of `repro.kernels.stencil_fifo.kernel._kernel` (level t
    reads ``fifo_old[t-1]`` and writes ``fifo_new[t]``; the grid step's end
    copies new to old)."""
    n = x.shape[0]
    nblocks = n // block
    fifo_old = x.new_zeros((steps + 1, 2))
    fifo_new = x.new_zeros((steps + 1, 2))
    out = torch.empty_like(x)
    xs = torch.arange(block, device=x.device)
    for j in range(nblocks + 1):
        row = (x[j * block:(j + 1) * block] if j < nblocks
               else x.new_zeros(block))
        fifo_new[0] = row[-2:]
        for t in range(1, steps + 1):
            prev_full = torch.cat([fifo_old[t - 1], row])
            new_row = (prev_full[:-2] + prev_full[1:-1] + prev_full[2:]) / 3.0
            cell = j * block - t + xs
            row = torch.where((cell >= 0) & (cell < n), new_row, 0.0)
            fifo_new[t] = row[-2:]
        out[max(j - 1, 0) * block:max(j - 1, 0) * block + block] = row
        fifo_old.copy_(fifo_new)
    return out


def jacobi_fifo(x: torch.Tensor, steps: int, block: int = 256
                ) -> torch.Tensor:
    """``steps`` jacobi-1d steps of ``x`` (N,) as float32; requires
    ``steps == block`` and ``N % block == 0`` (ValueError otherwise).
    Kernel 4, ``csrc/stencil_fifo.cu``, on a CUDA tensor;
    `_jacobi_fifo_plain` on a CPU one."""
    if x.dim() != 1:
        raise ValueError(f"jacobi_fifo takes a 1-d array, got shape "
                         f"{tuple(x.shape)}")
    _check(x.shape[0], steps, block)
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return _jacobi_fifo_plain(x, steps, block)
    if x.device.type != "cuda":
        raise ValueError(f"jacobi_fifo: no kernel for device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        cuda_lib.STENCIL_FIFO(
            x.data_ptr(), out.data_ptr(), x.shape[0], block, steps,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    return out
