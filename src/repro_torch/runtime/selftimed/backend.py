"""The ``"selftimed"`` registry backend.

Registers a scalar event-machine implementation per lowering: the same
`ChannelTrace` objects the reference backend replays vectorized run here
through genuinely per-event queue state machines — a third independent code
path for the order semantics and the peak-occupancy sweep, with
`OrderViolation` parity so `Analysis.validate(backend="selftimed")` passes
both the positive and negative directions.

The whole-PPN ``compile`` hook turns a planned `Analysis` into a
`SelfTimedMachine`: a bound executor whose ``run()`` performs the
back-pressured self-timed execution under the planned capacities
(`Analysis.compile(backend="selftimed").run(policy=...)`).

Everything here runs on the host.  The queue machines' ``run`` and the
compile hook take ``device`` only to refuse one: a request for any device
raises `ValueError` rather than running on the host in its place.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..lowering import (BROADCAST_REGISTER, CHUNK_SPLIT, DEPTH_SPLIT,
                        FIFO_STREAM, REORDER_BUFFER, ChannelLowering,
                        register_backend)
from ..simulator import ChannelTrace, OrderViolation
from .engine import execute_ppn
from .validate import planned_capacities

SELFTIMED = register_backend("selftimed")


def _events(trace: ChannelTrace) -> List[Tuple[int, int, int]]:
    """The trace's event stream in linearization order: ``(key, kind, arg)``
    with ``kind`` 0 = pop (arg = push position, pop order), 1 = push
    (arg = push position).  Keys are ``2·rank + is_write`` — reads drain
    before writes at equal rank, exactly the sweep semantics the vectorized
    backends implement."""
    ev: List[Tuple[int, int, int]] = []
    for v in range(trace.num_values):
        ev.append((2 * int(trace.value_wrank[v]) + 1, 1, v))
    # pops arrive in consumer-rank order; trace.pops is already that order
    r_sorted = np.sort(trace.r_rank, kind="stable")
    for i in range(trace.num_edges):
        ev.append((2 * int(r_sorted[i]), 0, int(trace.pops[i])))
    ev.sort(key=lambda e: (e[0], e[1]))
    return ev


def _host_only(device) -> None:
    if device is not None:
        raise ValueError(f"the 'selftimed' backend runs on the host; it "
                         f"takes no device (got {device!r})")


class _EventMachine(ChannelLowering):
    """Common chassis: walk the event stream one event at a time, tracking
    occupancy (a value stays live until its last pop) and delegating the pop
    legality to the subclass."""

    def run(self, trace: ChannelTrace, device=None) -> int:
        _host_only(device)
        pops_left = np.bincount(trace.pops, minlength=trace.num_values) \
            if trace.num_edges else np.zeros(0, dtype=np.int64)
        occ = 0
        peak = 0
        self._reset(trace)
        for _, kind, arg in _events(trace):
            if kind == 1:
                occ += 1
                peak = max(peak, occ)
            else:
                self._pop(trace, arg)
                pops_left[arg] -= 1
                if pops_left[arg] == 0:
                    occ -= 1
        return peak

    def _reset(self, trace: ChannelTrace) -> None:
        pass

    def _pop(self, trace: ChannelTrace, pos: int) -> None:
        raise NotImplementedError


@SELFTIMED.register(FIFO_STREAM, DEPTH_SPLIT, CHUNK_SPLIT)
class FifoQueueMachine(_EventMachine):
    """Strict FIFO: every pop must take exactly the current head."""

    def _reset(self, trace: ChannelTrace) -> None:
        self._head = 0

    def _pop(self, trace: ChannelTrace, pos: int) -> None:
        if pos != self._head:
            if pos < self._head:
                raise OrderViolation(
                    trace.channel,
                    f"value at push position {pos} popped again after the "
                    f"head advanced to {self._head} — a FIFO pop consumes "
                    f"the head")
            raise OrderViolation(
                trace.channel,
                f"out-of-order pop: wants push position {pos} while the "
                f"head is {self._head}")
        self._head += 1


@SELFTIMED.register(BROADCAST_REGISTER)
class BroadcastRegisterMachine(_EventMachine):
    """In-order broadcast register: the front may be popped repeatedly, but
    the stream never regresses."""

    def _reset(self, trace: ChannelTrace) -> None:
        self._front = 0

    def _pop(self, trace: ChannelTrace, pos: int) -> None:
        if pos < self._front:
            raise OrderViolation(
                trace.channel,
                f"register reuse after overwrite: pop wants push position "
                f"{pos} after the stream advanced to {self._front}")
        self._front = pos


@SELFTIMED.register(REORDER_BUFFER)
class ReorderBufferMachine(_EventMachine):
    """Addressable buffer: any pop order is fine."""

    def _pop(self, trace: ChannelTrace, pos: int) -> None:
        pass


class SelfTimedMachine:
    """A planned `Analysis` bound to the self-timed engine — the backend's
    whole-PPN compile artifact."""

    def __init__(self, analysis, capacities: Optional[Mapping[str, int]] = None):
        self.analysis = analysis
        self.capacities: Dict[str, int] = dict(
            capacities if capacities is not None
            else planned_capacities(analysis))

    def run(self, policy: str = "sequential",
            shrink: Optional[Mapping[str, int]] = None,
            record_timeline: bool = False,
            on_deadlock: str = "raise"):
        """Execute the network under the planned capacities (optionally
        shrinking named channels by N slots); returns a `SelfTimedReport`."""
        caps = dict(self.capacities)
        for name, delta in (shrink or {}).items():
            caps[name] = max(caps[name] - delta, 0)
        return execute_ppn(self.analysis.ppn, caps, policy=policy,
                           record_timeline=record_timeline,
                           on_deadlock=on_deadlock)


def _compile(analysis, device=None, **options) -> SelfTimedMachine:
    _host_only(device)
    return SelfTimedMachine(analysis, **options)


SELFTIMED.compile = _compile
