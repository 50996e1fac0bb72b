"""CUDA codegen support: planned PPNs → fused ring stencil kernels.

The port of `repro.runtime.pallas_codegen`.  This module holds the
*program* side of the ``"cuda"`` backend (`runtime/cuda_backend.py` holds
the per-channel trace-replay implementations and registers both into the
lowering registry): a time-tiled band stencil whose iteration space is
blocked along one *streamed* spatial axis, with the dependences crossing
the block boundary — the channels the paper's SPLIT isolates at each depth
— carried in a ring from one block to the next.  In-block dependences
never leave the kernel's working rows; the addressable-buffer fallback
round-trips the whole array through device memory per timestep instead
(the FPGA FIFO-vs-buffer saving, restated for the GPU memory hierarchy).

The generated geometry, for a stencil of radius ``r`` along the streamed
axis (items are scalars for jacobi-1d, rows for jacobi-2d, planes for
heat-3d; the skew is ``r`` cells per time step so tile writes stay
block-aligned):

* ring level ``t`` holds the trailing ``2r`` items of the global item
  stream at time level ``t`` — block ``j`` deposits them, block ``j+1``
  consumes them;
* the ring has ``steps + 1`` levels; levels are addressed modulo
  ``ring_depth`` (default ``steps + 1``), so an *undersized* ring is a real
  ring-capacity failure (level ``t`` is clobbered before the next block
  reads it), not an index error;
* blocks need ``r·steps ≡ 0 (mod block)`` so the skewed final row is
  block-aligned; ``r·steps / block`` extra flush blocks drain the tail.
  ``block = 1`` (the degenerate 1×…×1 tiling) is supported: the trailing
  halo then accumulates across several predecessor blocks.

Two kernels run here, each a hand-written CUDA kernel with a plain PyTorch
version of the same algorithm beside it: `ring_stencil` (``csrc/
ring_stencil.cu``) and `addressable_step` (``csrc/addressable_step.cu``).
A wrapper runs the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.

`compile_analysis` is the `Analysis.compile(backend="cuda")` entry point:
it reads the `.plan()` records, picks the ring mode iff every planned
lowering is a stream/register (`is_cheap`), and binds the kernel's
*semantics* from the `STENCIL_PROGRAMS` table (the polyhedral spec carries
dataflow, not arithmetic — the update function is the one ingredient the
analysis cannot derive).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels import cuda_lib
from ..kernels.stencil_bands.ref import heat_3d, jacobi_2d
from ..kernels.stencil_fifo.ref import jacobi_1d

# ---------------------------------------------------------------- programs --

@dataclass(frozen=True)
class StencilProgram:
    """The semantic half of a band-stencil kernel: what one time step
    computes.  ``update`` receives ``2·radius + 1`` tensors — the previous
    time level shifted by ``-radius … +radius`` along the streamed axis,
    each of shape ``(block,) + inner`` — and returns the new level.  Inner
    (non-streamed) axes are full-width; their boundary handling lives
    inside ``update`` (Dirichlet-zero, matching the `ref` oracle).
    ``cuda_kind`` selects the same update in ``csrc/stencil_update.cuh``."""

    name: str                                  # registry kernel it mirrors
    radius: int                                # dependence radius, streamed axis
    inner_rank: int                            # rank of one streamed item
    update: Callable[..., torch.Tensor]
    ref: Callable[[torch.Tensor, int], torch.Tensor]   # PyTorch oracle
    cuda_kind: int
    notes: str = ""


def _shift_inner(a: torch.Tensor, axis: int, off: int) -> torch.Tensor:
    """``a`` shifted by ``off`` along ``axis`` with Dirichlet-zero fill."""
    if off == 0:
        return a
    pad_shape = list(a.shape)
    pad_shape[axis] = abs(off)
    zeros = a.new_zeros(pad_shape)
    n = a.shape[axis]
    if off > 0:      # neighbor at index - off
        return torch.cat([zeros, a.narrow(axis, 0, n - off)], dim=axis)
    return torch.cat([a.narrow(axis, -off, n + off), zeros], dim=axis)


def _jacobi1d_update(left, center, right):
    return (left + center + right) / 3.0


def _jacobi2d_update(up, center, down):
    jl = _shift_inner(center, -1, +1)
    jr = _shift_inner(center, -1, -1)
    return (center + jl + jr + up + down) / 5.0


def _heat3d_update(up, center, down):
    jl = _shift_inner(center, -2, +1)
    jr = _shift_inner(center, -2, -1)
    kl = _shift_inner(center, -1, +1)
    kr = _shift_inner(center, -1, -1)
    return (center
            + 0.125 * (up - 2.0 * center + down)
            + 0.125 * (jl - 2.0 * center + jr)
            + 0.125 * (kl - 2.0 * center + kr))


#: kernel-registry name → band-stencil semantics.  The analysis plans the
#: channels; this table supplies the arithmetic the PPN does not carry.
STENCIL_PROGRAMS: Dict[str, StencilProgram] = {
    "jacobi-1d": StencilProgram(
        "jacobi-1d", radius=1, inner_rank=0, update=_jacobi1d_update,
        ref=jacobi_1d, cuda_kind=0,
        notes="3-point average; items are cells (paper Fig. 1/3)"),
    "jacobi-2d": StencilProgram(
        "jacobi-2d", radius=1, inner_rank=1, update=_jacobi2d_update,
        ref=jacobi_2d, cuda_kind=1,
        notes="5-point average; items are rows, j streams inside"),
    "heat-3d": StencilProgram(
        "heat-3d", radius=1, inner_rank=2, update=_heat3d_update,
        ref=heat_3d, cuda_kind=2,
        notes="7-point star; items are planes, (j,k) stream inside"),
}


# ------------------------------------------------------ kernel wrappers -----

def _inner_dims(x: torch.Tensor) -> Tuple[int, int]:
    inner = tuple(x.shape[1:]) + (1, 1)
    return int(inner[0]), int(inner[1])


def _check_cuda_input(x: torch.Tensor, program: StencilProgram) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{program.name}: the CUDA kernels take a "
                         f"contiguous float32 tensor, got {x.dtype}")
    if program.radius != 1 or x.dim() != program.inner_rank + 1:
        raise ValueError(f"{program.name}: the CUDA kernels take radius 1 "
                         f"and rank {program.inner_rank + 1}, got radius "
                         f"{program.radius} and shape {tuple(x.shape)}")


def _ring_plain(x: torch.Tensor, program: StencilProgram, steps: int,
                block: int, ring_depth: int, halo: int) -> torch.Tensor:
    """The plain PyTorch version of the ring kernel: the Pallas grid walked
    in order, one block at a time, with the two ring copies of
    `repro.runtime.pallas_codegen._ring_kernel` (level t reads
    ``ring_old[(t-1) % depth]`` and writes ``ring_new[t % depth]``; the
    block's end copies new to old)."""
    r = program.radius
    n_items, inner = x.shape[0], tuple(x.shape[1:])
    nblocks, flush = n_items // block, (r * steps) // block
    ring_old = x.new_zeros((ring_depth, halo) + inner)
    ring_new = x.new_zeros((ring_depth, halo) + inner)
    out = torch.empty_like(x)
    ids = torch.arange(block, device=x.device).reshape(
        (block,) + (1,) * len(inner))
    for j in range(nblocks + flush):
        row = (x[j * block:(j + 1) * block] if j < nblocks
               else x.new_zeros((block,) + inner))
        ring_new[0] = torch.cat([ring_old[0], row])[-halo:]
        for t in range(1, steps + 1):
            prev_full = torch.cat([ring_old[(t - 1) % ring_depth], row])
            if halo < 2 * r:      # injected narrow halo: the missing items
                prev_full = torch.cat(   # are GONE
                    [x.new_zeros((2 * r - halo,) + inner), prev_full])
            new_row = program.update(*[prev_full[k:k + block]
                                       for k in range(2 * r + 1)])
            idx = j * block - r * t + ids
            new_row = torch.where((idx >= 0) & (idx < n_items), new_row,
                                  0.0)
            ring_new[t % ring_depth] = torch.cat(
                [ring_old[t % ring_depth], new_row])[-halo:]
            row = new_row
        if j >= flush:       # earlier blocks' outputs are overwritten
            out[(j - flush) * block:(j - flush + 1) * block] = row
        ring_old.copy_(ring_new)
    return out


def ring_scratch(x: torch.Tensor, block: int, ring_depth: int,
                 halo: int) -> torch.Tensor:
    """The ring kernel's global scratch for ``x``: two ring copies and two
    working rows."""
    d1, d2 = _inner_dims(x)
    floats = (2 * ring_depth * halo + 2 * block) * d1 * d2
    return torch.empty(floats, dtype=torch.float32, device=x.device)


def ring_stencil(x: torch.Tensor, program: StencilProgram, steps: int,
                 block: int, ring_depth: int, halo: int) -> torch.Tensor:
    """``steps`` time levels of ``program`` over ``x`` with the cross-block
    channels in a ring of ``ring_depth`` levels × ``halo`` items: kernel 1,
    ``csrc/ring_stencil.cu`` on a CUDA tensor, `_ring_plain` on a CPU one.
    Raises ValueError on a geometry the kernel cannot run."""
    p = program
    if x.dim() != p.inner_rank + 1:
        raise ValueError(f"{p.name}: expected rank {p.inner_rank + 1} "
                         f"input, got shape {tuple(x.shape)}")
    if x.shape[0] % block:
        raise ValueError(f"n_items {x.shape[0]} % block {block} != 0")
    if (p.radius * steps) % block:
        raise ValueError(f"radius·steps ({p.radius * steps}) must be a "
                         f"multiple of block ({block}) so skewed writes "
                         f"stay block-aligned")
    if ring_depth < 1 or halo < 1:
        raise ValueError(f"ring of {ring_depth} level(s) × {halo} item(s)")
    if x.device.type == "cpu":
        return _ring_plain(x, program, steps, block, ring_depth, halo)
    if x.device.type != "cuda":
        raise ValueError(f"ring_stencil: no kernel for device {x.device}")
    _check_cuda_input(x, program)
    d1, d2 = _inner_dims(x)
    out = torch.empty_like(x)
    scratch = ring_scratch(x, block, ring_depth, halo)
    with torch.cuda.device(x.device):
        cuda_lib.RING_STENCIL(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            program.cuda_kind, x.shape[0], d1, d2, steps, block, ring_depth,
            halo, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    return out


def _addressable_plain(x: torch.Tensor, program: StencilProgram
                       ) -> torch.Tensor:
    """The plain PyTorch version of the addressable step: the whole level
    shifted by ``radius - k`` along the streamed axis, then one update."""
    r = program.radius
    return program.update(*[_shift_inner(x, 0, r - k)
                            for k in range(2 * r + 1)])


def addressable_step(x: torch.Tensor, program: StencilProgram
                     ) -> torch.Tensor:
    """One time step of ``program`` over the whole array: kernel 2,
    ``csrc/addressable_step.cu`` on a CUDA tensor, `_addressable_plain` on
    a CPU one."""
    if x.device.type == "cpu":
        return _addressable_plain(x, program)
    if x.device.type != "cuda":
        raise ValueError(f"addressable_step: no kernel for device {x.device}")
    _check_cuda_input(x, program)
    d1, d2 = _inner_dims(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        cuda_lib.ADDRESSABLE_STEP(
            x.data_ptr(), out.data_ptr(), program.cuda_kind, x.shape[0], d1,
            d2, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    return out


# ------------------------------------------------------------ executable ----

@dataclass
class CompiledStencil:
    """The executable `Analysis.compile(backend="cuda")` returns.

    ``mode`` is ``"fifo-ring"`` (fused kernel, channels in a ring carried
    from block to block) or ``"addressable"`` (per-timestep device-memory
    round trip — the fallback a reorder-buffer plan forces).  ``ring_depth``
    / ``halo`` exist for the negative direction: compiling with fewer ring
    levels than ``steps + 1`` (or a narrower halo than ``2·radius``)
    produces a kernel whose output provably diverges from the oracle — an
    undersized ring *fails*, it does not degrade gracefully.  Inputs are
    moved to ``device`` as float32; the output stays there.
    """

    program: StencilProgram
    mode: str
    plans: Tuple = ()
    kernel_name: str = ""
    device: str = "cuda"
    diagnostics: Dict[str, object] = field(default_factory=dict)

    def ring_slots(self, steps: int) -> int:
        """Items held in one ring buffer: (steps+1) levels × 2r per level
        (each item is one channel value of inner shape)."""
        return (steps + 1) * 2 * self.program.radius

    def __call__(self, x, steps: int, block: int,
                 ring_depth: Optional[int] = None,
                 halo: Optional[int] = None) -> torch.Tensor:
        p = self.program
        x = torch.as_tensor(x).to(device=self.device,
                                  dtype=torch.float32).contiguous()
        if self.mode == "addressable":
            a = x
            for _ in range(steps):      # deliberately NOT fused: one kernel
                a = addressable_step(a, p)   # launch + full round trip per t
            return a
        depth = steps + 1 if ring_depth is None else ring_depth
        h = 2 * p.radius if halo is None else halo
        return ring_stencil(x, p, steps, block, depth, h)

    def describe(self) -> str:
        return (f"CompiledStencil[{self.program.name}] mode={self.mode} "
                f"radius={self.program.radius} device={self.device} "
                f"plans={len(self.plans)} ({self.diagnostics})")


def _memory_channels(analysis) -> frozenset:
    """Names of channels touching a load/store (memory) process.  In the
    generated kernel these are the input and output arrays in device memory
    — addressable by nature — so their verdicts never force the addressable
    *compute* mode; only compute↔compute channels decide ring vs. buffer."""
    mem = lambda p: p.startswith(("load", "store"))
    return frozenset(ch.name for ch in analysis.ppn.channels
                     if mem(ch.producer) or mem(ch.consumer))


def compile_analysis(analysis, mode: Optional[str] = None,
                     device: Optional[str] = None) -> CompiledStencil:
    """The cuda backend's `Backend.compile` hook.

    Requires a `.plan()` stage: the ChannelPlan records decide the mode —
    the fused ring kernel iff every compute↔compute lowering is served by a
    stream/register (`is_cheap`; load/store-process channels are the arrays
    in device memory and are exempt), else the addressable per-timestep
    fallback.  ``mode`` forces one (the benchmark measures both).
    ``device`` (``None`` meaning ``"cuda"``) is where the executable runs."""
    if analysis.plans is None:
        raise ValueError("compile() needs the .plan() stage: run "
                         "analyze(...).classify().fifoize().size().plan() "
                         "first — the ChannelPlan records ARE the input")
    name = analysis.ppn.kernel_name
    program = STENCIL_PROGRAMS.get(name)
    if program is None:
        raise KeyError(
            f"no cuda stencil program for kernel {name!r} "
            f"(have: {sorted(STENCIL_PROGRAMS)}) — the PPN carries dataflow, "
            f"not arithmetic; register the update in STENCIL_PROGRAMS")
    memory = _memory_channels(analysis)
    compute_plans = [p for p in analysis.plans if p.name not in memory]
    cheap = all(p.is_cheap for p in compute_plans)
    expensive = [p.name for p in compute_plans if not p.is_cheap]
    if mode is None:
        mode = "fifo-ring" if cheap else "addressable"
    if mode == "fifo-ring" and not cheap:
        raise ValueError(
            f"{name}: cannot compile the ring kernel — plan(s) "
            f"{expensive} need the addressable reorder buffer (run "
            f".fifoize() first, or compile mode='addressable')")
    if mode not in ("fifo-ring", "addressable"):
        raise ValueError(f"unknown mode {mode!r}")
    return CompiledStencil(
        program=program, mode=mode, plans=tuple(analysis.plans),
        kernel_name=name, device="cuda" if device is None else str(device),
        diagnostics={"cheap_plans": sum(p.is_cheap for p in compute_plans),
                     "compute_plans": len(compute_plans),
                     "memory_plans": len(memory),
                     "reorder_plans": expensive})
