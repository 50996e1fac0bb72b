"""Trace-driven reference PPN simulator — the ``"reference"`` backend.

Every planned channel implementation is *executed* here against the channel's
dataflow trace: producer/consumer events replay in global-schedule (lex-rank)
order through the implementation the plan selected — a strict FIFO queue for
FIFO verdicts, an in-order broadcast register for in-order+multiplicity, an
addressable reorder buffer for out-of-order — raising on any pop the
implementation cannot serve and tracking peak occupancy.

The replay is **vectorized**, not per-event Python: traces are built from the
per-process joint global lex ranks already memoized in the analysis'
`SizingContext` (`pair_rank`), so "replaying" a channel is a handful of numpy
array ops over dense integer ranks:

* the *push sequence* is the channel's distinct producer instances (values)
  in write-rank order;
* the *pop sequence* is the edge list sorted by consumer rank (ties resolve
  in queue order — equal ranks are simultaneous);
* a FIFO executes iff every pushed value is popped exactly once, in push
  order; a register tolerates repeated pops of the front value but no
  regression; a reorder buffer accepts any pop order.

The order checks compare producer-local against consumer-local execution
order (restricted to one process, the joint rank IS its local order), so
they are exact for any PPN.  The joint *cross-process* interleaving is the
tiled sequential linearization the sizing model assumes; channels it cannot
serialize (a read ranked before its write — e.g. a consumer whose
rectangular tiling pins a tile coordinate the producer still iterates, as in
symm's ``accupd->cfin``) execute self-timed in reality and are surfaced as
``late_edges`` on the trace rather than failed.

Peak occupancy comes from an event sweep (+1 at a value's write, −1 after its
last read, reads draining before writes at equal rank) implemented as a
lexsort + cumulative sum — deliberately a *different* code path from the
bincount sweep in `core/sizing.py`, so `Analysis.validate()` cross-checks the
two implementations value-for-value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..core.patterns import _lex_rank
from ..core.ppn import PPN, Channel
from ..core.sizing import SizingContext
from .lowering import (BROADCAST_REGISTER, CHUNK_SPLIT, DEPTH_SPLIT,
                       FIFO_STREAM, REORDER_BUFFER, ChannelLowering,
                       register_backend)


class SimulationError(RuntimeError):
    """The planned implementation could not execute the channel's trace."""

    def __init__(self, channel: str, detail: str):
        super().__init__(f"{channel}: {detail}")
        self.channel = channel
        self.detail = detail


class OrderViolation(SimulationError):
    """A pop arrived that the (FIFO / register) front could not serve."""


@dataclass
class ChannelTrace:
    """One channel's replayable event trace, in dense joint-rank form.

    ``pops`` is the per-edge *push position* of the popped value, in pop
    (consumer-rank) order — the exact sequence a queue implementation sees.
    """

    channel: str
    num_values: int                 # distinct producer instances
    num_edges: int
    w_rank: np.ndarray              # per-edge producer joint rank
    r_rank: np.ndarray              # per-edge consumer joint rank
    value_wrank: np.ndarray         # per-value write rank
    value_last_read: np.ndarray     # per-value last-read rank
    pops: np.ndarray                # per-edge push position, pop order

    @property
    def late_mask(self) -> np.ndarray:
        """Per-edge mask of the non-serializable edge set: reads ranked at
        or before their write.  This is THE exemption set — trace replay
        counts these instead of failing them, and the self-timed engine's
        occupancy cross-check exempts exactly the same edges
        (`channel_late_edges`)."""
        return self.r_rank <= self.w_rank

    @property
    def late_edges(self) -> int:
        """Edges the sequential linearization cannot serialize (read ranked
        at or before its write) — served by blocking in a self-timed run."""
        return int(np.count_nonzero(self.late_mask))

    def peak_occupancy(self) -> int:
        """Max live values during replay: event sweep over (write, last-read)
        pairs, reads draining before writes at the same rank (the event key is
        ``2·rank + is_write``, matching the sequential-schedule semantics)."""
        if self.num_values == 0:
            return 0
        keys = np.concatenate([2 * self.value_wrank + 1,
                               2 * self.value_last_read])
        deltas = np.concatenate([
            np.ones(self.num_values, dtype=np.int64),
            -np.ones(self.num_values, dtype=np.int64)])
        occ = np.cumsum(deltas[np.argsort(keys, kind="stable")])
        return int(max(0, occ.max()))


def trace_channel(ppn: PPN, ch: Channel,
                  sizing: Optional[SizingContext] = None) -> ChannelTrace:
    """Build the replay trace from the memoized joint ranks (`pair_rank`)."""
    sizing = sizing if sizing is not None else SizingContext(ppn)
    sizing.ppn = ppn
    n = ch.num_edges
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return ChannelTrace(ch.name, 0, 0, z, z, z, z, z)
    jp, jc = sizing.pair_rank(ch.producer, ch.consumer)
    w_rows = sizing.rows_of(ch.producer, ch.src_pts)
    w_rank = jp[w_rows]
    r_rank = jc[sizing.rows_of(ch.consumer, ch.dst_pts)]
    # values = distinct producer instances (the write rows ARE the identity)
    _, vinv = np.unique(w_rows, return_inverse=True)
    num_values = int(vinv.max()) + 1
    value_wrank = np.empty(num_values, dtype=np.int64)
    value_wrank[vinv] = w_rank              # all edges of a value agree
    order = np.argsort(vinv, kind="stable")
    sorted_v = vinv[order]
    starts = np.concatenate(
        [[0], np.flatnonzero(sorted_v[1:] != sorted_v[:-1]) + 1])
    value_last_read = np.maximum.reduceat(r_rank[order], starts)
    # push position: dense rank of the write rank (ties = simultaneous)
    push_pos = _lex_rank(value_wrank[:, None])
    pops = push_pos[vinv][np.lexsort((push_pos[vinv], r_rank))]
    return ChannelTrace(ch.name, num_values, n, w_rank, r_rank,
                        value_wrank, value_last_read, pops)


def channel_late_edges(ppn: PPN, sizing: Optional[SizingContext] = None
                       ) -> "dict":
    """Per-channel late-edge counts for the whole network — the shared
    exemption set: trace replay reports these per channel (and per split
    part), and `validate(mode="selftimed")` exempts exactly these channels
    from the peak-equality cross-check."""
    sizing = sizing if sizing is not None else SizingContext(ppn)
    return {ch.name: trace_channel(ppn, ch, sizing).late_edges
            for ch in ppn.channels}


REFERENCE = register_backend("reference")


@REFERENCE.register(FIFO_STREAM, DEPTH_SPLIT, CHUNK_SPLIT)
class FifoQueueSim(ChannelLowering):
    """Strict FIFO queue: pops must drain values exactly once, in push order.
    (The split lowerings are the same queue applied to each recovered part —
    `validate` re-splits the channel and replays every part through this.)"""

    def run(self, trace: ChannelTrace) -> int:
        if trace.num_edges != trace.num_values:
            counts = np.bincount(trace.pops, minlength=trace.num_values) \
                if trace.num_edges else np.zeros(trace.num_values, np.int64)
            dup = np.flatnonzero(counts > 1)
            if len(dup):
                d = int(dup[0])
                raise OrderViolation(
                    trace.channel,
                    f"value at push position {d} popped "
                    f"{int(counts[d])} times — a FIFO pop consumes the head")
            gap = int(np.flatnonzero(counts == 0)[0])
            raise OrderViolation(
                trace.channel,
                f"gap: value at push position {gap} was pushed but never "
                f"popped — a FIFO head cannot be skipped")
        regress = np.flatnonzero(np.diff(trace.pops) < 0)
        if len(regress):
            i = int(regress[0])
            raise OrderViolation(
                trace.channel,
                f"out-of-order pop: pop {i + 1} wants push position "
                f"{int(trace.pops[i + 1])} while the head is past "
                f"{int(trace.pops[i])}")
        return trace.peak_occupancy()


@REFERENCE.register(BROADCAST_REGISTER)
class BroadcastRegisterSim(ChannelLowering):
    """In-order broadcast: the front value may be popped repeatedly (local
    multicast register); popping an already-retired value raises."""

    def run(self, trace: ChannelTrace) -> int:
        regress = np.flatnonzero(np.diff(trace.pops) < 0)
        if len(regress):
            i = int(regress[0])
            raise OrderViolation(
                trace.channel,
                f"register reuse after overwrite: pop {i + 1} wants push "
                f"position {int(trace.pops[i + 1])} after the stream "
                f"advanced to {int(trace.pops[i])}")
        return trace.peak_occupancy()


@REFERENCE.register(REORDER_BUFFER)
class ReorderBufferSim(ChannelLowering):
    """Addressable buffer: pops in any order."""

    def run(self, trace: ChannelTrace) -> int:
        return trace.peak_occupancy()


def simulate_channel(ppn: PPN, ch: Channel, lowering: str,
                     sizing: Optional[SizingContext] = None) -> int:
    """Replay one channel through the named lowering on the reference
    backend; returns peak occupancy, raises `SimulationError` when the
    implementation cannot serve the trace."""
    impl = REFERENCE.implementation(lowering)
    return impl.run(trace_channel(ppn, ch, sizing))
