"""Runtime guards: detect live what the classifier proved statically.

The paper's verdicts license cheap lowerings by *proving* order properties
of the schedule.  These guards check the same properties at runtime, so a
violated assumption (a fault, a mis-planned capacity, a buggy transport)
is **detected** — never a silent wrong answer:

* **sequence tags** — every token carries its wire position; a FIFO-lowered
  channel's consumer checks each pop is the next tag (gap / out-of-order /
  duplicate all show), a broadcast register checks tags never regress, an
  addressable buffer checks payload integrity and, at completion, pop
  completeness;
* **multiset audit** (`audit_trace`) — trace-level completeness: the popped
  multiset must equal the expected per-value multiplicities (catches drops
  and duplicates that an order discipline alone tolerates, e.g. a skipped
  head under the cuda ring's ``v <= last_p`` check);
* **progress watchdog** (`ProgressWatchdog`) — bounds quiesce
  interventions so recovery never becomes a hang, and distinguishes
  fault-induced stall (an actor refusing work — observable as
  `ProcessStats.denials`) from genuine structural deadlock (the engine's
  wait-for cycle).

`guarded_replay` is the trace-level entry: replay a (possibly faulted)
trace through a backend's channel implementation *and* the multiset audit,
mapping every failure to a `GuardViolation` naming the culprit channel.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..lowering import (BROADCAST_REGISTER, REORDER_BUFFER, STREAM_LOWERINGS,
                        backend)
from ..simulator import ChannelTrace, SimulationError
from .faults import expected_pop_counts

#: guard discipline per lowering: what ordering property the tags check
GUARD_MODES: Dict[str, str] = dict(
    {low: "fifo" for low in STREAM_LOWERINGS},
    **{BROADCAST_REGISTER: "register", REORDER_BUFFER: "reorder"})


def mode_for_lowering(lowering: str) -> str:
    """``"fifo"`` | ``"register"`` | ``"reorder"`` — the tag discipline a
    channel with this lowering is guarded by."""
    return GUARD_MODES.get(lowering, "reorder")


class GuardViolation(RuntimeError):
    """A runtime guard detected a violated channel contract.

    ``channel`` names the culprit, ``violation`` is the detected condition
    (``gap`` | ``duplicate`` | ``out-of-order`` | ``corrupt``), and
    ``mechanism`` names the guard that caught it."""

    def __init__(self, channel: str, violation: str, mechanism: str,
                 detail: str):
        super().__init__(f"{channel}: {violation} ({mechanism}): {detail}")
        self.channel = channel
        self.violation = violation
        self.mechanism = mechanism
        self.detail = detail


def audit_trace(trace: ChannelTrace,
                expected: np.ndarray) -> Optional[GuardViolation]:
    """Multiset audit: compare the trace's popped multiset against the
    expected per-value multiplicities; returns the violation (None if
    clean).  This is the completeness half of the guard — order disciplines
    check *sequence*, this checks *conservation*."""
    got = (np.bincount(trace.pops, minlength=trace.num_values)
           if trace.num_edges else np.zeros(trace.num_values, np.int64))
    if len(got) > len(expected):      # a pop named a nonexistent position
        return GuardViolation(
            trace.channel, "corrupt", "multiset-audit",
            f"pop of push position {int(len(got) - 1)} beyond the "
            f"{len(expected)} values ever pushed")
    missing = np.flatnonzero(got < expected)
    if len(missing):
        m = int(missing[0])
        return GuardViolation(
            trace.channel, "gap", "multiset-audit",
            f"value at push position {m} popped {int(got[m])} of the "
            f"expected {int(expected[m])} times")
    extra = np.flatnonzero(got > expected)
    if len(extra):
        e = int(extra[0])
        return GuardViolation(
            trace.channel, "duplicate", "multiset-audit",
            f"value at push position {e} popped {int(got[e])} times, "
            f"expected {int(expected[e])}")
    return None


def guarded_replay(trace: ChannelTrace, lowering: str,
                   backend_name: str = "reference",
                   expected: Optional[np.ndarray] = None,
                   **impl_kw) -> int:
    """Replay ``trace`` through ``backend_name``'s implementation of
    ``lowering`` with the guards armed: the implementation's own order
    discipline plus the multiset audit (against ``expected`` pop counts —
    pass the unfaulted trace's `expected_pop_counts`; defaults to this
    trace's own, which makes the audit a no-op for self-consistent traces).

    Returns the implementation's peak occupancy; raises `GuardViolation`
    naming the culprit channel on any detected violation."""
    exp = expected if expected is not None else expected_pop_counts(trace)
    impl = backend(backend_name).implementation(lowering)
    try:
        peak = impl.run(trace, **impl_kw)
    except SimulationError as e:
        detail = e.detail if hasattr(e, "detail") else str(e)
        violation = ("duplicate" if "popped" in detail and "times" in detail
                     else "gap" if "gap" in detail or "empty slot" in detail
                     else "out-of-order")
        raise GuardViolation(trace.channel, violation,
                             f"{backend_name}:{lowering}", detail) from e
    bad = audit_trace(trace, exp)
    if bad is not None:
        raise bad
    return peak


class ProgressWatchdog:
    """Bounds the guards' quiesce interventions (never a hang) and keeps the
    stall-vs-deadlock ledger.

    Each time the engine quiesces with work pending the hooks call
    `tick()`; once the budget is spent the watchdog answers ``False`` and
    the engine falls through to its structural deadlock report — so a
    recovery loop that makes no progress terminates in bounded time, by
    construction rather than by timeout.  `restart()` separately budgets
    crashed-actor restarts (`FaultPlan.max_restarts`)."""

    def __init__(self, limit: int, max_restarts: int):
        self.limit = limit
        self.max_restarts = max_restarts
        self.ticks = 0
        self.restarts = 0
        self.exhausted = False

    def tick(self) -> bool:
        """One quiesce intervention; False once the budget is spent."""
        self.ticks += 1
        if self.ticks > self.limit:
            self.exhausted = True
            return False
        return True

    def restart(self) -> bool:
        """One crashed-actor restart; False once the budget is spent."""
        if self.restarts >= self.max_restarts:
            return False
        self.restarts += 1
        return True

    def as_dict(self) -> Dict[str, int]:
        return {"ticks": self.ticks, "limit": self.limit,
                "restarts": self.restarts,
                "max_restarts": self.max_restarts,
                "exhausted": self.exhausted}
