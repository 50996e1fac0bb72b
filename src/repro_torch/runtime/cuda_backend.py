"""The ``"cuda"`` backend: lowering IR executed as real ring kernels.

The port of `repro.runtime.pallas_backend`.  Where the ``"reference"``
backend replays a channel's trace with numpy array ops, this backend
replays the SAME trace through the memory structure the lowering buys — a
ring of slots addressed by a hand-written CUDA kernel (``csrc/replay.cu``;
on a CPU device, its plain PyTorch version):

* the stream family (`FIFO_STREAM` and both split variants) and the
  broadcast register run the trace's push/pop/retire events against a ring
  of ``slots`` words, checking *in kernel* that every pop finds the value
  it expects (an undersized ring gets clobbered and fails as
  `RingOverflow` — the negative direction `Analysis.validate` demands) and
  that the pop order is one the structure can serve (violations surface as
  the same `OrderViolation` the reference backend raises, so the
  validator's negative checks work unchanged on this backend);
* the reorder buffer runs the same kernel with order checking disabled —
  addressable scratch, any pop order, still capacity-checked.

Event lists are built host-side from the dense-rank trace
(`simulator.trace_channel`): pushes at key ``2·w_rank + 1``, retires at
``2·last_read``, pops at ``2·r_rank``, sorted by ``(key, kind)`` with
push < pop < retire at equal key — the exact sweep semantics of
`ChannelTrace.peak_occupancy`.  Edges the sequential linearization cannot
serialize (``late_edges``: a pop ranked at/before its push — self-timed in
reality) get their push forced early to ``min(2·w_rank+1, 2·first_read)``
so the kernel can still serve them; the reported peak then comes from the
host sweep, matching the reference backend's accounting.

Ring slots are assigned host-side by greedy interval allocation (optimal:
max-live slots suffice), then folded modulo the ring size — so compiling
with fewer slots than peak occupancy provably collides instead of silently
widening the buffer.

The whole-PPN compiler (`Backend.compile` hook → `Analysis.compile`) lives
in `runtime.cuda_codegen`; this module wires it to the registry.  The
lowerings also carry the pipeline ring's ``step`` hooks, as the reference's
pallas lowerings do, so ``lowering="cuda:ppermute"`` runs the ring
(`comm.pipeline`): the ``"torch"`` backend's steps (`comm.channels`), no
kernel launched.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..comm.channels import ring_gather, ring_hop
from ..kernels import cuda_lib
from .cuda_codegen import compile_analysis
from .lowering import (BROADCAST_REGISTER, CHUNK_SPLIT, DEPTH_SPLIT,
                       FIFO_STREAM, REORDER_BUFFER, ChannelLowering,
                       register_backend)
from .simulator import ChannelTrace, OrderViolation, SimulationError

# event kinds (host-built, executed in kernel order)
_PUSH, _POP, _RETIRE, _NOOP = 0, 1, 2, 3
# order disciplines (kernel argument)
_FIFO, _REGISTER, _REORDER = 0, 1, 2


class RingOverflow(SimulationError):
    """The ring was too small for the trace: a push clobbered a live slot,
    or a pop read back a value the ring no longer held."""


@dataclass(frozen=True)
class _EventList:
    """A channel trace lowered to ring operations, in replay order."""

    kind: np.ndarray       # _PUSH/_POP/_RETIRE per event
    value: np.ndarray      # push position the event concerns
    slot: np.ndarray       # greedy-allocated ring slot (pre-modulo)
    needed: int            # slots a collision-free replay requires


def _build_events(trace: ChannelTrace) -> _EventList:
    """Lower the dense-rank trace to a push/pop/retire event list with
    host-assigned ring slots.  Values are identified by PUSH POSITION
    (write-rank order), the identity `trace.pops` already uses."""
    nv, ne = trace.num_values, trace.num_edges
    # push position <-> value id (per-process ranks are strictly ordered,
    # so value_wrank has no ties and this is a bijection)
    order = np.argsort(trace.value_wrank, kind="stable")
    pos_of_value = np.empty(nv, dtype=np.int64)
    pos_of_value[order] = np.arange(nv)
    wrank_by_pos = trace.value_wrank[order]
    last_read_by_pos = trace.value_last_read[order]
    # pops arrive in consumer-rank order; their keys are the sorted r_ranks
    pop_keys = 2 * np.sort(trace.r_rank, kind="stable")
    first_read_by_pos = np.full(nv, np.iinfo(np.int64).max)
    np.minimum.at(first_read_by_pos, trace.pops, pop_keys)
    # late edges: force the push early enough to serve its first pop
    push_keys = np.minimum(2 * wrank_by_pos + 1, first_read_by_pos)
    retire_keys = 2 * last_read_by_pos
    kind = np.concatenate([np.full(nv, _PUSH), np.full(ne, _POP),
                           np.full(nv, _RETIRE)]).astype(np.int64)
    value = np.concatenate([np.arange(nv), trace.pops,
                            np.arange(nv)]).astype(np.int64)
    key = np.concatenate([push_keys, pop_keys, retire_keys])
    perm = np.lexsort((kind, key))           # push < pop < retire at a tie
    kind, value = kind[perm], value[perm]
    # greedy interval allocation: lowest free slot at push, freed at retire
    slot = np.zeros(len(kind), dtype=np.int64)
    free: list = []
    top = 0
    held = np.empty(nv, dtype=np.int64)
    needed = 0
    for i, (k, v) in enumerate(zip(kind, value)):
        if k == _PUSH:
            s = heapq.heappop(free) if free else top
            if s == top:
                top += 1
            held[v] = s
            needed = max(needed, s + 1)
        elif k == _RETIRE:
            heapq.heappush(free, held[v])
        slot[i] = held[v]
    return _EventList(kind, value, slot, max(1, needed))


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


# ------------------------------------------------------------- kernel 3 ----

#: events a tile of the replay kernel holds (``TILE`` in ``csrc/replay.cu``)
REPLAY_TILE = 4096


def _replay_walk(kind: torch.Tensor, value: torch.Tensor,
                 slot: torch.Tensor, ring_size: int,
                 order_op: int) -> torch.Tensor:
    """The events walked one after another on the host values of the
    tensors: the oracle the tiled scan is held to."""
    ring = [-1] * ring_size
    live = peak = order_v = mism = ovf = unf = 0
    last_p = -1
    for k, v, s in zip(kind.tolist(), value.tolist(), slot.tolist()):
        cur = ring[s]
        push, pop, retire = k == _PUSH, k == _POP, k == _RETIRE
        ovf += push and cur != -1
        unf += pop and cur == -1
        mism += pop and cur != v and cur != -1
        if pop:
            if order_op == _FIFO:           # head-only, consumed once
                order_v += v <= last_p
            elif order_op == _REGISTER:     # front re-readable, no regression
                order_v += v < last_p
            last_p = max(last_p, v)
        ring[s] = v if push else -1 if retire else cur
        live += push - retire
        peak = max(peak, live)
    return torch.tensor([peak, order_v, mism, ovf, unf, live],
                        dtype=torch.int32, device=kind.device)


def _replay_plain(kind: torch.Tensor, value: torch.Tensor,
                  slot: torch.Tensor, ring_size: int, order_op: int,
                  tile: int = REPLAY_TILE) -> torch.Tensor:
    """The plain PyTorch version of the replay kernel, in its order: tiles
    of ``tile`` events, every event of a tile at once.  ``live`` is a
    prefix sum of push − retire; the pop order reads an exclusive prefix
    maximum of the values popped; the state an event sees in its slot is
    the last push (its value) or retire (−1) on that slot before it in the
    tile — a stable sort by slot, then a segmented last-writer pass — else
    what the ring held when the tile began.  Each slot's last writer
    updates the ring at the tile's end."""
    n = kind.numel()
    kind, value, slot = (t.to(torch.int64) for t in (kind, value, slot))
    ring = torch.full((ring_size,), -1, dtype=torch.int64, device=kind.device)
    live = peak = order_v = mism = ovf = unf = 0
    last_p = -1
    for base in range(0, n, tile):
        k, v, s = (t[base:base + tile] for t in (kind, value, slot))
        push, pop, retire = k == _PUSH, k == _POP, k == _RETIRE
        live_after = live + torch.cumsum(push.long() - retire.long(), 0)
        peak = max(peak, int(live_after.max()))
        popped = torch.where(pop, v, torch.iinfo(torch.int64).min)
        most = torch.cummax(popped, 0).values
        before = torch.cat([most.new_full((1,), last_p), most[:-1]])
        before = torch.clamp(before, min=last_p)
        if order_op == _FIFO:
            order_v += int((pop & (v <= before)).sum())
        elif order_op == _REGISTER:
            order_v += int((pop & (v < before)).sum())
        # slot state: stable sort by slot, last writer within each segment
        order = torch.argsort(s, stable=True)
        ss, sk, sv = s[order], k[order], v[order]
        pos = torch.arange(len(ss), device=ss.device)
        writes = (sk == _PUSH) | (sk == _RETIRE)
        written = torch.where(sk == _PUSH, sv, -1)
        head = torch.ones_like(writes)
        head[1:] = ss[1:] != ss[:-1]
        start = torch.cummax(torch.where(head, pos, 0), 0).values
        last = torch.cummax(torch.where(writes, pos, -1), 0).values
        last_before = torch.cat([last.new_full((1,), -1), last[:-1]])
        cur = torch.where(last_before >= start,
                          written[last_before.clamp(min=0)], ring[ss])
        ovf += int(((sk == _PUSH) & (cur != -1)).sum())
        unf += int(((sk == _POP) & (cur == -1)).sum())
        mism += int(((sk == _POP) & (cur != sv) & (cur != -1)).sum())
        tail = torch.ones_like(writes)
        tail[:-1] = ss[1:] != ss[:-1]
        update = tail & (last >= start)
        ring[ss[update]] = written[last[update]]
        live = int(live_after[-1])
        last_p = max(last_p, int(popped.max()))
    return torch.tensor([peak, order_v, mism, ovf, unf, live],
                        dtype=torch.int32, device=kind.device)


def replay_events(kind: torch.Tensor, value: torch.Tensor,
                  slot: torch.Tensor, ring_size: int,
                  order_op: int) -> torch.Tensor:
    """Run an int32 event list against a ring of ``ring_size`` slots
    initialised to -1; returns int32 ``[peak, order_violations,
    mismatches, overflows, underflows, live]``.  Kernel 3,
    ``csrc/replay.cu``, on CUDA tensors; `_replay_plain` on CPU ones.

    Every slot must lie in ``[0, ring_size)``.  On CPU tensors a slot
    outside raises ValueError; on CUDA tensors the range is not read back
    (that would cost a device-to-host sync a call, before the caller's own
    read of the result): the caller checks it, as `_RingReplay.run` does on
    its host arrays, and the kernel leaves an event outside the ring
    unrun."""
    if ring_size < 1:
        raise ValueError(f"replay_events: a ring of {ring_size} slots")
    if kind.device.type == "cpu":
        if slot.numel() and not (0 <= int(slot.min())
                                 and int(slot.max()) < ring_size):
            raise ValueError(f"replay_events: a slot lies outside the "
                             f"ring of {ring_size}")
        return _replay_plain(kind, value, slot, ring_size, order_op)
    if kind.device.type != "cuda":
        raise ValueError(f"replay_events: no kernel for device {kind.device}")
    for t in (kind, value, slot):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.shape != kind.shape or t.device != kind.device):
            raise ValueError("replay_events takes three contiguous int32 "
                             "event tensors of one shape on one device")
    ring = torch.empty(ring_size, dtype=torch.int32, device=kind.device)
    out = torch.empty(6, dtype=torch.int32, device=kind.device)
    with cuda_lib.on_device(kind.device):
        cuda_lib.REPLAY(
            kind.data_ptr(), value.data_ptr(), slot.data_ptr(),
            kind.numel(), ring.data_ptr(), ring_size, order_op,
            out.data_ptr(), cuda_lib.raw_stream(kind.device))
    return out


@dataclass(frozen=True)
class RingEvents:
    """The int32 event list `_RingReplay.run` hands kernel 3: ``kind``,
    ``value`` and ``slot`` padded with NOOPs to a power of two, slots
    folded modulo the ``nslots`` the ring was asked for, on a ring of
    ``ring`` (the next power of two) slots."""

    kind: np.ndarray
    value: np.ndarray
    slot: np.ndarray
    ring: int
    nslots: int
    needed: int


def ring_events(trace: ChannelTrace,
                slots: Optional[int] = None) -> RingEvents:
    """Lower a trace with edges to the event list kernel 3 replays on
    ``slots`` ring slots (``None``: as many as a collision-free replay
    needs)."""
    ev = _build_events(trace)
    nslots = ev.needed if slots is None else max(1, int(slots))
    n = len(ev.kind)
    pad = _pow2(n) - n
    kind, value, slot = (
        np.concatenate([ev.kind, np.full(pad, _NOOP)]),
        np.concatenate([ev.value, np.zeros(pad, dtype=np.int64)]),
        np.concatenate([ev.slot % nslots, np.zeros(pad, dtype=np.int64)]))
    ring = _pow2(nslots)
    if not 0 <= slot.min() <= slot.max() < ring:
        raise ValueError(f"{trace.channel}: a slot lies outside the "
                         f"ring of {ring}")
    return RingEvents(kind.astype(np.int32), value.astype(np.int32),
                      slot.astype(np.int32), ring, nslots, ev.needed)


class _RingReplay(ChannelLowering):
    """Shared machinery: lower the trace to events, run the kernel, raise."""

    order_op: int = _REORDER

    def run(self, trace: ChannelTrace, slots: Optional[int] = None,
            device=None) -> int:
        if trace.num_edges == 0:
            return 0
        ev = ring_events(trace, slots)
        nslots = ev.nslots
        dev = torch.device("cuda" if device is None else device)
        kind, value, slot = (torch.from_numpy(a).to(dev)
                             for a in (ev.kind, ev.value, ev.slot))
        peak, order_v, mism, ovf, unf = replay_events(
            kind, value, slot, ev.ring, self.order_op).tolist()[:5]
        if order_v:
            raise OrderViolation(
                trace.channel,
                f"{order_v} pop(s) the {self.lowering!r} ring cannot "
                f"serve (pop order violates the structure's discipline)")
        if ovf or mism or unf:
            raise RingOverflow(
                trace.channel,
                f"ring of {nslots} slot(s) too small for the trace: "
                f"{ovf} clobbering push(es), {mism} corrupted pop(s), "
                f"{unf} pop(s) from an empty slot "
                f"(needs {ev.needed} slots)")
        # forced-early pushes (self-timed edges) inflate the kernel's live
        # counter; report the sequential-schedule peak the validator checks
        return peak if trace.late_edges == 0 else trace.peak_occupancy()


CUDA = register_backend("cuda")


@CUDA.register(FIFO_STREAM, DEPTH_SPLIT, CHUNK_SPLIT)
class VmemRingFifo(_RingReplay):
    """FIFO verdicts: a ring carried along the streamed axis, popped
    strictly in push order (the generated-kernel idiom of `cuda_codegen`;
    split variants are the same ring per part).  On Hopper the ring of the
    fused stencil lives in shared memory or, when it does not fit, in an
    L2-resident global scratch; this replay keeps its slots in global
    memory."""

    order_op = _FIFO

    step = staticmethod(ring_hop)


@CUDA.register(BROADCAST_REGISTER)
class CarriedRegister(_RingReplay):
    """In-order+multiplicity: the front value stays readable (a value the
    consumer keeps in a register on Hopper); only regression past the
    stream head fails."""

    order_op = _REGISTER

    step = staticmethod(ring_hop)


@CUDA.register(REORDER_BUFFER)
class AddressableVmem(_RingReplay):
    """Out-of-order: addressable scratch sized by `Analysis.size()` slots
    (device memory on Hopper) — any pop order, capacity still enforced."""

    order_op = _REORDER

    step = staticmethod(ring_gather)


# whole-PPN compiler: Analysis.compile(backend="cuda") resolves here
CUDA.compile = compile_analysis


# ------------------------------------------------------------ timing hook ---

#: how long the stream is held before the timed calls, at first: far longer
#: than the host takes to queue a few wrapper calls, doubled while it is not
MEASURE_STALL_S = 2e-3
MEASURE_STALL_TRIES = 8
#: the clock the stall's cycles are counted at (the H100 SXM's boost)
_STALL_CLOCK_HZ = 1.98e9


def measure_input(program, n_items: int, block: int, device,
                  seed: int = 0) -> torch.Tensor:
    """The array `measure_compiled` times ``program`` on: ``n_items`` items
    of inner widths ``max(4, block)``, standard normal from ``seed``."""
    shape = (n_items,) + tuple(max(4, block)
                               for _ in range(program.inner_rank))
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)


def measure_compiled(compiled, n_items: int, steps: int, block: int,
                     repeats: int = 1, seed: int = 0) -> dict:
    """Time one compiled stencil (`Analysis.compile(backend="cuda")`) on a
    concrete geometry on the device: best-of-``repeats`` after a warm-up
    call, the `bench_pallas` discipline.  This is the DSE's *measured* cost
    channel.

    The seconds are the device's, not the host's: the stream is held by a
    spin (``torch.cuda._sleep``) while the host queues the ``repeats``
    calls, each between two CUDA events, so the card runs them back to
    back and an event interval is one call's kernels (for the addressable
    fallback, its ``steps`` launches and the gaps between them).  Where the
    card reached the first event before the host had queued the last call,
    the window is taken again with a stall twice as long; ``calls`` counts
    every wrapper call made, the warm-up included.

    Raises ValueError on a geometry the kernel cannot run (`n_items` not a
    multiple of ``block``, skew misalignment) — callers decide whether to
    snap the geometry or skip the measurement, but never get a silently
    different one — and on an executable that does not run on a card (a
    device time is measured on the device or not at all)."""
    p = compiled.program
    if n_items % block:
        raise ValueError(f"n_items {n_items} % block {block} != 0")
    if (p.radius * steps) % block:
        raise ValueError(f"radius*steps ({p.radius * steps}) % block "
                         f"{block} != 0")
    if torch.device(compiled.device).type != "cuda":
        raise ValueError(f"measure_compiled times on a CUDA device, not "
                         f"{compiled.device!r}")
    x = measure_input(p, n_items, block, compiled.device, seed)
    reps = max(1, repeats)

    compiled(x, steps, block)                     # build + warm
    calls, stall = 1, MEASURE_STALL_S
    with torch.cuda.device(x.device):
        for _ in range(MEASURE_STALL_TRIES):
            torch.cuda.synchronize()
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(reps + 1)]
            torch.cuda._sleep(int(stall * _STALL_CLOCK_HZ))
            events[0].record()
            for e in events[1:]:
                compiled(x, steps, block)
                e.record()
            calls += reps
            queued_ahead = not events[0].query()
            events[-1].synchronize()
            if queued_ahead:
                break
            stall *= 2
        else:
            raise RuntimeError(
                f"measure_compiled: the host did not queue {reps} call(s) "
                f"within a stall of {stall / 2:.3g} s")
    best = min(a.elapsed_time(b) for a, b in zip(events, events[1:])) / 1e3
    return {"seconds": best, "mode": compiled.mode,
            "n_items": n_items, "steps": steps, "block": block,
            "device": torch.cuda.get_device_name(torch.device(
                compiled.device)),
            "repeats": reps, "calls": calls}
