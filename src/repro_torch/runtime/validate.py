"""Operational validation: execute every verdict, don't just trust it.

`Analysis.validate()` lands here.  For each channel of the analyzed PPN the
stage replays the dataflow trace through the implementation the verdict (or
the plan record) selects, in both directions:

* **positive** — the planned implementation must execute the trace: a FIFO
  verdict must pop in order on a strict queue, an in-order+multiplicity
  verdict must stream through the broadcast register, a split plan must
  execute every recovered part on its own FIFO;
* **negative** — a non-FIFO verdict must *fail* on a FIFO queue (and an
  out-of-order verdict must also fail on the register).  A "broken" channel
  that replays cleanly on the cheap implementation means the classifier
  over-approximated — exactly the bug a verdict-driven lowering would turn
  into silent data corruption, caught here instead;
* **occupancy** — the replay's peak occupancy must equal the sizing
  backend's exact capacity (two independent sweep implementations) and fit
  the planned ``size()`` slots.

The order checks are exact for any PPN (they compare per-process local
orders).  Occupancy replays the tiled sequential linearization the sizing
model assumes; edges that linearization cannot serialize (self-timed in a
real run — see `simulator.ChannelTrace.late_edges`) are counted per channel
in the report rather than failed, mirroring how `core/sizing.py` has always
treated them.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core.patterns import Pattern, _classify_channels
from ..core.ppn import PPN, Channel
from ..core.sizing import _channel_capacity, pow2_size
from ..core.split import split_by_tile_pair, split_channel
from .lowering import (CHUNK_SPLIT, DEPTH_SPLIT, FIFO_STREAM,
                       BROADCAST_REGISTER, backend, lowering_for_pattern)
from .simulator import OrderViolation, SimulationError, trace_channel


class ValidationError(AssertionError):
    """At least one verdict or buffer size failed its operational check."""

    def __init__(self, kernel: str, failures: List[str]):
        self.kernel = kernel
        self.failures = list(failures)
        lines = "\n  ".join(failures)
        super().__init__(f"{kernel}: {len(failures)} operational check(s) "
                         f"failed:\n  {lines}")


@dataclass
class ChannelValidation:
    """One channel's operational evidence."""

    name: str
    verdict: str                    # classifier pattern value
    lowering: str                   # implementation the trace replayed on
    parts: int                      # replayed parts (1 unless a split plan)
    peak: int                       # replay peak occupancy (sum over parts)
    capacity: int                   # sizing backend's exact capacity
    slots: int                      # planned slot count checked against
    rejected: Tuple[str, ...] = ()  # lowerings confirmed to FAIL (negative)
    late: int = 0                   # edges the linearization can't serialize
    #: the non-serializable edge set broken down per replayed part — for a
    #: split plan the regenerated parts' counts (previously computed inside
    #: the replay and dropped), for an unsplit channel {name: late}.  This
    #: is what lets selftimed and trace replay agree on which edges are
    #: exempt at part granularity.
    late_parts: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "verdict": self.verdict,
                "lowering": self.lowering, "parts": self.parts,
                "peak": self.peak, "capacity": self.capacity,
                "slots": self.slots, "rejected": list(self.rejected),
                "late": self.late, "late_parts": dict(self.late_parts)}


@dataclass
class ValidationReport:
    """The validate stage's artifact (embedded in `AnalysisReport`)."""

    kernel: str
    backend: str
    channels: List[ChannelValidation] = field(default_factory=list)

    @property
    def replays(self) -> int:
        return sum(c.parts for c in self.channels)

    @property
    def rejections(self) -> int:
        return sum(len(c.rejected) for c in self.channels)

    def as_dict(self) -> Dict[str, Any]:
        return {"backend": self.backend,
                "replays": self.replays, "rejections": self.rejections,
                "channels": [c.as_dict() for c in self.channels]}

    def summary(self) -> str:
        peak = sum(c.peak for c in self.channels)
        slots = sum(c.slots for c in self.channels)
        late = sum(c.late for c in self.channels)
        extra = f", {late} self-timed edges" if late else ""
        return (f"{self.kernel}: {len(self.channels)} channels operationally "
                f"confirmed ({self.replays} replays, {self.rejections} "
                f"negative rejections), peak {peak} <= {slots} slots{extra}")


class _OnDevice:
    """A backend whose implementations' ``run`` receives ``device`` (left
    out when ``None``, so backends without a device keep their signature)."""

    def __init__(self, b, device) -> None:
        self._b, self._device = b, device

    def implementation(self, lowering: str):
        impl = self._b.implementation(lowering)      # a fresh instance
        if self._device is not None:
            impl.run = functools.partial(impl.run, device=self._device)
        return impl


#: splitter behind each split lowering (regenerates the plan's parts)
_SPLITTERS = {DEPTH_SPLIT: split_channel, CHUNK_SPLIT: split_by_tile_pair}


def validate_analysis(analysis, backend_name: str = "cuda",
                      device=None) -> ValidationReport:
    """Run the operational checks for every channel of ``analysis``;
    returns the evidence, raises `ValidationError` on any contradiction.

    ``backend_name`` picks the executing registry backend: ``"reference"``
    (numpy trace replay) or ``"cuda"`` (the same traces run through ring
    kernels on ``device``; ``None`` leaves the backend's default) — both
    implement ``run(trace) -> peak`` and raise `OrderViolation`
    identically, so the positive AND negative directions hold on either.

    Uses whatever stages ran: verdicts come from the shared classifier,
    slot counts from `.size()` when present (else the pow2 capacities the
    stage would produce), lowerings from `.plan()` records when present
    (else the verdict table).  Plan slot checks are skipped for
    ``topology="pipeline"`` plans — tick capacities bound a self-timed
    execution, not the program-order replay."""
    ppn = analysis.ppn
    ctx = analysis.ctx
    clf = ctx.classifier(ppn)
    sizing = ctx.sizing(ppn)
    patterns = (dict(analysis.patterns) if analysis.patterns is not None
                else _classify_channels(ppn, classifier=clf))
    plan_by_name = ({p.name: p for p in analysis.plans}
                    if analysis.plans is not None else {})
    sizes = dict(analysis.sizes) if analysis.sizes is not None else None
    ref = _OnDevice(backend(backend_name), device)

    report = ValidationReport(ppn.kernel_name, backend_name)
    failures: List[str] = []
    for ch in ppn.channels:
        verdict = patterns[ch.name]
        plan = plan_by_name.get(ch.name)
        lowering = (plan.lowering if plan is not None
                    else lowering_for_pattern(verdict))
        capacity = _channel_capacity(ppn, ch, context=sizing)
        slots = (sizes[ch.name] if sizes is not None
                 else pow2_size(capacity))
        trace = trace_channel(ppn, ch, sizing)
        parts = 1
        late_parts = {ch.name: trace.late_edges}
        # -- positive: the planned implementation must execute the trace
        try:
            if plan is not None and plan.split:
                peak, late_parts = _replay_split_parts(ref, ppn, ch, plan,
                                                       sizing, failures)
                parts = len(plan.parts)
            else:
                peak = ref.implementation(lowering).run(trace)
        except SimulationError as e:
            failures.append(f"{ch.name}: verdict {verdict.value!r} does not "
                            f"execute on {lowering!r}: {e.detail}")
            peak = -1
        # -- occupancy: replay peak == exact capacity, <= planned slots
        if peak >= 0 and (plan is None or not plan.split):
            if peak != capacity:
                failures.append(
                    f"{ch.name}: replay peak occupancy {peak} != sizing "
                    f"capacity {capacity} — the two sweeps disagree")
            if peak > slots:
                failures.append(f"{ch.name}: peak occupancy {peak} exceeds "
                                f"the {slots} planned slots")
        # -- negative: cheaper implementations must REJECT the trace
        rejected = _negative_checks(ref, trace, verdict, failures)
        report.channels.append(ChannelValidation(
            ch.name, verdict.value, lowering, parts, max(peak, 0), capacity,
            slots, rejected, sum(late_parts.values()), late_parts))
    if failures:
        raise ValidationError(ppn.kernel_name, failures)
    return report


def _replay_split_parts(ref, ppn: PPN, ch: Channel, plan, sizing,
                        failures: List[str]) -> Tuple[int, Dict[str, int]]:
    """A split plan executes as one FIFO per recovered part: regenerate the
    parts with the plan's splitter and replay each on a strict queue,
    checking the per-part slot counts from the plan record.  Returns the
    total peak and the per-part late-edge counts — the regenerated parts'
    non-serializable edge sets used to be computed here and dropped; now
    they ride into the report so the selftimed engine exempts the same
    edges at part granularity."""
    parts = _SPLITTERS[plan.lowering](ppn, ch)
    slots_by_depth = {depth: size for depth, _, size in plan.parts}
    if sorted(slots_by_depth) != sorted(p.depth for p in parts):
        failures.append(f"{ch.name}: split regeneration produced parts "
                        f"{sorted(p.depth for p in parts)} but the plan "
                        f"recorded {sorted(slots_by_depth)}")
        return -1, {ch.name: trace_channel(ppn, ch, sizing).late_edges}
    fifo = ref.implementation(FIFO_STREAM)
    total = 0
    late_parts: Dict[str, int] = {}
    for part in parts:
        trace = trace_channel(ppn, part, sizing)
        late_parts[part.name] = trace.late_edges
        peak = fifo.run(trace)
        cap = _channel_capacity(ppn, part, context=sizing)
        if peak != cap:
            failures.append(f"{part.name}: part replay peak {peak} != "
                            f"sizing capacity {cap}")
        if plan.topology == "sequential" and peak > slots_by_depth[part.depth]:
            failures.append(f"{part.name}: part peak {peak} exceeds its "
                            f"{slots_by_depth[part.depth]} planned slots")
        total += peak
    return total, late_parts


def _negative_checks(ref, trace, verdict: Pattern,
                     failures: List[str]) -> Tuple[str, ...]:
    """A non-FIFO verdict must fail on the FIFO queue; a non-in-order verdict
    must also fail on the broadcast register.  Success on a cheaper
    implementation means the classifier over-approximated."""
    if verdict is Pattern.FIFO or trace.num_edges == 0:
        return ()
    rejected: List[str] = []
    expect_reject = [FIFO_STREAM]
    if verdict in (Pattern.OOO, Pattern.OOO_UNICITY):
        expect_reject.append(BROADCAST_REGISTER)
    for lowering in expect_reject:
        try:
            ref.implementation(lowering).run(trace)
        except OrderViolation:
            rejected.append(lowering)
        else:
            failures.append(
                f"{trace.channel}: verdict {verdict.value!r} but the trace "
                f"executes cleanly on {lowering!r} — classifier "
                f"over-approximation")
    return tuple(rejected)
