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

`jacobi_fifo` runs ``csrc/stencil_fifo.cu`` on a CUDA tensor: every
block in flight at once (in rounds where one CTA cannot hold them all,
`fifo_launch`), each on the same time level, with the FIFO a channel
between the workers of consecutive blocks.  On a CPU tensor it runs
`_jacobi_fifo_plain`, the same wave order in PyTorch; `_jacobi_fifo_walk`
walks the Pallas grid in order and is the oracle both are held to.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import cuda_lib


def _check(n: int, steps: int, block: int) -> None:
    if steps != block or block < 1 or n % block:
        raise ValueError(f"jacobi_fifo needs steps == block and "
                         f"N % block == 0, got N={n}, steps={steps}, "
                         f"block={block}")


def _jacobi_fifo_walk(x: torch.Tensor, steps: int,
                      block: int) -> torch.Tensor:
    """The Pallas grid walked in order, with the two FIFO copies of
    `repro.kernels.stencil_fifo.kernel._kernel` (level t reads
    ``fifo_old[t-1]`` and writes ``fifo_new[t]``; the grid step's end copies
    new to old): the oracle the wave order is held to."""
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


def _jacobi_fifo_plain(x: torch.Tensor, steps: int,
                       block: int) -> torch.Tensor:
    """The plain PyTorch version, in the kernel's wave order: every block
    (the flush block included) in flight at once, all on level t together,
    each reading the two FIFO cells its left neighbour handed over at level
    t − 1 (a one-cell block broadcasts its cell into both, as the
    reference's ``row[-2:]`` does; block 0 reads zeros).  The kernel's
    rounds of `FifoLaunch.workers` blocks compute the same levels."""
    n = x.shape[0]
    nb = n // block + 1
    rows = torch.cat([x, x.new_zeros(block)]).view(nb, block)
    cell0 = (torch.arange(nb, device=x.device)[:, None] * block
             + torch.arange(block, device=x.device)[None, :])
    edge = x.new_zeros((1, 2))
    for t in range(1, steps + 1):
        fifo = torch.cat([edge, rows[:-1, -2:].expand(nb - 1, 2)])
        prev_full = torch.cat([fifo, rows], dim=1)
        new_rows = (prev_full[:, :-2] + prev_full[:, 1:-1]
                    + prev_full[:, 2:]) / 3.0
        cell = cell0 - t
        rows = torch.where((cell >= 0) & (cell < n), new_rows, 0.0)
    return rows[1:].reshape(-1)


@dataclass(frozen=True)
class FifoLaunch:
    """How kernel 4 runs a call: ``workers`` blocks in flight in one CTA,
    each held by ``threads_per_worker`` threads of at most `CELLS` cells,
    over ``rounds`` rounds; ``waves`` is the chain, the levels computed one
    after another (``rounds × steps``)."""

    workers: int
    threads_per_worker: int
    rounds: int
    waves: int

    @property
    def threads(self) -> int:
        return -(-self.workers * self.threads_per_worker // 32) * 32


#: the most cells a thread holds in registers (``CELLS`` in
#: ``csrc/stencil_fifo.cu``), and the threads of the one CTA
CELLS = 8
MAX_THREADS = 1024


def fifo_launch(n: int, block: int, workers: Optional[int] = None,
                threads_per_worker: Optional[int] = None) -> FifoLaunch:
    """Kernel 4's launch for ``n`` cells in blocks of ``block`` (steps ==
    block).  By default as many workers as the blocks (the flush block
    included) or one CTA's threads allow, each of as many threads as keep
    those blocks in one round at 4 cells a thread, else at 8 (a warp's level
    is shorter with 4 cells than with 8, and 2 gained nothing:
    `bench/fifo_sweep.py`); a thread holds at least two cells where the
    block has two.  The arguments force either, for the card's tests and
    sweeps; the kernel refuses a split it cannot run."""
    nb = n // block + 1
    tpw = threads_per_worker
    if tpw is None:
        fits = [t for t in (-(-block // c) for c in (4, CELLS))
                if (t == 1 or block >= 2 * t) and nb * t <= MAX_THREADS]
        tpw = fits[0] if fits else -(-block // CELLS)
    g = workers or max(1, min(nb, MAX_THREADS // tpw))
    rounds = -(-nb // g)
    return FifoLaunch(g, tpw, rounds, rounds * block)


def _jacobi_fifo_with(x: torch.Tensor, steps: int, block: int,
                      launch: FifoLaunch) -> torch.Tensor:
    """Kernel 4 on a CUDA tensor at a given launch (`jacobi_fifo` checks
    the arguments and picks the launch)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    with cuda_lib.on_device(x.device):
        cuda_lib.STENCIL_FIFO(
            x.data_ptr(), out.data_ptr(), x.shape[0], block, steps,
            launch.workers, launch.threads_per_worker,
            cuda_lib.raw_stream(x.device))
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
    return _jacobi_fifo_with(x, steps, block, fifo_launch(x.shape[0], block))
