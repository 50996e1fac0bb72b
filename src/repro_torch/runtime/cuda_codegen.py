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
import functools
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

def _inner_dims(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """(d1, d2) of an item of an array of ``shape``: its rows and their
    cells (1 for an axis it lacks)."""
    inner = tuple(shape[1:]) + (1, 1)
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


#: CTAs a cluster may hold on Hopper (16 with the non-portable attribute)
MAX_CLUSTER = 16
#: items of a block one ring thread may walk (the kernel is built for each)
SEGMENTS = (8, 4, 2, 1)
#: where the ring's CTAs are and where their tiles live: one cluster with
#: the tiles in shared memory, or a cooperative grid of up to one CTA an SM
#: with them in the L2-resident global scratch
RING_MODES = ("shared", "grid")


@dataclass(frozen=True)
class RingCard:
    """What a ring launch shape depends on in the card: its ``sms``, the
    ``smem_bytes`` of shared memory a CTA may opt in to, and the threads a
    CTA of the kernel may have where a thread walks ``seg`` items,
    ``max_threads[seg]`` (the kernel's launch bound).  `ring_card` reads
    them from the device and the kernel."""

    sms: int
    smem_bytes: int
    max_threads: Dict[int, int]


@functools.lru_cache(maxsize=None)
def _ring_card(index: int) -> RingCard:
    out = (ctypes.c_int * 6)()
    cuda_lib.RING_LIMITS(index, out, launches=0)
    return RingCard(out[0], out[1], {1 << i: out[2 + i] for i in range(4)})


def ring_card(device: torch.device) -> RingCard:
    """The `RingCard` of CUDA ``device``, from ``ring_stencil_limits`` in
    ``csrc/ring_stencil.cu``."""
    return _ring_card(torch.cuda.current_device() if device.index is None
                      else device.index)


@dataclass(frozen=True)
class RingLaunch:
    """The ring kernel's launch shape for one geometry: ``ctas`` CTAs in
    ``mode`` (`RING_MODES`), each owning ``rows`` of the item's d1 rows
    (its tile: ``stride`` floats an item, padded to 128 bytes), of
    ``threads`` × ``segments`` threads, a thread walking ``block /
    segments`` items of its columns.  The tile's two ring copies and three
    working rows (each the ring level's ``halo`` items, then the block)
    take ``tile_floats``: in ``smem_bytes`` of shared memory, or, where
    that is 0, in a global scratch of ``scratch_floats``."""

    mode: str
    ctas: int
    rows: int
    stride: int
    threads: int
    segments: int
    tile_floats: int
    smem_bytes: int
    scratch_floats: int

    def describe(self) -> str:
        where = (f"{self.smem_bytes} B of shared memory a CTA"
                 if self.smem_bytes else
                 f"a {4 * self.scratch_floats} B global scratch")
        group = ("a cooperative grid" if self.mode == "grid" else
                 f"a cluster of {self.ctas}")
        return (f"{self.ctas} CTA(s) in {group}, {self.threads}x"
                f"{self.segments} threads, {self.rows} row(s) a CTA, tiles "
                f"in {where}")


def ring_launch(shape: Tuple[int, ...], block: int, ring_depth: int,
                halo: int, card: RingCard) -> RingLaunch:
    """The launch shape of `ring_stencil` for an input of ``shape`` on
    ``card``: the item's d1 rows spread over one cluster of up to 16 CTAs
    with the tiles in shared memory where they fit there, else over a
    cooperative grid of up to one CTA an SM.  Threads: the block cut into
    segments of 8, 4, 2 or 1 items so that a thread walks the fewest
    columns, with the most threads."""
    return _ring_launch(shape, block, ring_depth, halo, card)


def _ring_launch(shape: Tuple[int, ...], block: int, ring_depth: int,
                 halo: int, card: RingCard, ctas: Optional[int] = None,
                 mode: Optional[str] = None) -> RingLaunch:
    """`ring_launch` with the CTAs capped at ``ctas`` and the mode forced
    to ``mode`` where given: a shape the card may refuse at launch, for
    the tests and the bench."""
    if mode not in (None,) + RING_MODES:
        raise ValueError(f"ring mode {mode!r} is none of {RING_MODES}")
    d1, d2 = _inner_dims(shape)

    def tiles(most: int):
        rows = -(-d1 // min(most, d1))
        stride = -(-(rows * d2) // 32) * 32
        return (-(-d1 // rows), rows, stride,
                (2 * ring_depth * halo + 3 * (halo + block)) * stride)

    if mode is None:
        fits = 4 * tiles(ctas or MAX_CLUSTER)[3] <= card.smem_bytes
        mode = "shared" if fits else "grid"
    most = ctas or (card.sms if mode == "grid" else MAX_CLUSTER)
    n_ctas, rows, stride, tile = tiles(most)
    width = rows * d2
    limit = card.max_threads
    shapes = [(seg, *_ring_threads(width, block // seg, limit[seg]))
              for seg in SEGMENTS
              if block % seg == 0 and block // seg <= limit[seg]]
    if not shapes:
        raise ValueError(f"block {block}: no split into segments of "
                         f"{SEGMENTS} items that a CTA's threads can hold")
    # the fewest columns a thread walks a level (each costs a round trip
    # to the tile), then the most threads, then the longest segments
    seg, threads, _ = min(shapes, key=lambda t: (t[2], -t[1] * block // t[0],
                                                 -t[0]))
    if mode == "shared" and 4 * tile > card.smem_bytes:
        raise ValueError(f"ring tiles of {4 * tile} B pass the "
                         f"{card.smem_bytes} B of shared memory a CTA may "
                         f"hold")
    smem = 4 * tile if mode == "shared" else 0
    return RingLaunch(mode, n_ctas, rows, stride, threads, block // seg,
                      tile, smem, 0 if smem else n_ctas * tile)


def _ring_threads(width: int, segments: int, limit: int) -> Tuple[int, int]:
    """Threads along a tile's ``width`` columns for ``segments`` segments
    of ``seg`` items under ``limit`` threads a CTA (whole warps where there
    are 32 columns or more), and the columns each thread walks."""
    cap = limit // segments
    threads = (min(width, cap) if width < 32 or cap < 32
               else min(-(-width // 32) * 32, cap // 32 * 32))
    return threads, -(-width // threads)


def ring_stencil(x: torch.Tensor, program: StencilProgram, steps: int,
                 block: int, ring_depth: int, halo: int) -> torch.Tensor:
    """``steps`` time levels of ``program`` over ``x`` with the cross-block
    channels in a ring of ``ring_depth`` levels × ``halo`` items: kernel 1,
    ``csrc/ring_stencil.cu`` on a CUDA tensor, launched as `ring_launch`
    gives (a launch that cannot be placed raises RuntimeError);
    `_ring_plain` on a CPU one.  Raises ValueError on a geometry the
    kernel cannot run."""
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
    return _ring_stencil_with(
        x, program, steps, block, ring_depth, halo,
        ring_launch(tuple(x.shape), block, ring_depth, halo,
                    ring_card(x.device)))


def _ring_stencil_with(x: torch.Tensor, program: StencilProgram, steps: int,
                       block: int, ring_depth: int, halo: int,
                       shape: RingLaunch) -> torch.Tensor:
    """Kernel 1 on CUDA tensor ``x`` (checked by `ring_stencil`) at launch
    ``shape``."""
    d1, d2 = _inner_dims(x.shape)
    out = torch.empty_like(x)
    scratch = torch.empty(shape.scratch_floats, dtype=torch.float32,
                          device=x.device)
    with cuda_lib.on_device(x.device):
        cuda_lib.RING_STENCIL(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            program.cuda_kind, x.shape[0], d1, d2, steps, block, ring_depth,
            halo, shape.ctas, shape.rows, shape.stride, shape.threads,
            shape.segments, shape.smem_bytes, int(shape.mode == "grid"),
            cuda_lib.raw_stream(x.device))
    return out


def _addressable_plain(x: torch.Tensor, program: StencilProgram
                       ) -> torch.Tensor:
    """The plain PyTorch version of the addressable step: the whole level
    shifted by ``radius - k`` along the streamed axis, then one update."""
    r = program.radius
    return program.update(*[_shift_inner(x, 0, r - k)
                            for k in range(2 * r + 1)])


def addressable_steps(x: torch.Tensor, program: StencilProgram,
                      steps: int) -> torch.Tensor:
    """``steps`` time steps of ``program`` over the whole array, one launch
    of kernel 2 (``csrc/addressable_step.cu``) each, every level a round
    trip through device memory: the checks, the two ping-pong buffers and
    the stream are taken once a job, and the launches are queued from C.
    ``steps`` chained `_addressable_plain` calls on a CPU tensor.  Returns
    ``x`` itself for ``steps == 0``."""
    if steps < 0:
        raise ValueError(f"steps = {steps} < 0")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"addressable_step: no kernel for device "
                             f"{x.device}")
        for _ in range(steps):
            x = _addressable_plain(x, program)
        return x
    _check_cuda_input(x, program)
    if steps == 0:
        return x
    d1, d2 = _inner_dims(x.shape)
    a = torch.empty_like(x)
    b = torch.empty_like(x) if steps > 1 else None
    device = x.device
    with cuda_lib.on_device(device):
        cuda_lib.ADDRESSABLE_STEP(
            x.data_ptr(), a.data_ptr(), 0 if b is None else b.data_ptr(),
            program.cuda_kind, x.shape[0], d1, d2, steps,
            cuda_lib.raw_stream(device), launches=steps)
    return a if steps % 2 else b


def addressable_step(x: torch.Tensor, program: StencilProgram
                     ) -> torch.Tensor:
    """One time step of ``program`` over the whole array: kernel 2,
    ``csrc/addressable_step.cu`` on a CUDA tensor, `_addressable_plain` on
    a CPU one."""
    return addressable_steps(x, program, 1)


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
            # deliberately NOT fused: one launch and one round trip a step
            return addressable_steps(x, p, steps)
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
