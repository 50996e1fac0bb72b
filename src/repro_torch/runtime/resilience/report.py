"""The artifact of one guarded (fault-injected or clean) execution.

A `ResilienceReport` accounts for the whole detect → recover → degrade
ladder of a run:

* ``injected`` — every fault the plan actually triggered;
* ``detections`` — each violated contract, with the guard mechanism that
  caught it and the culprit channel/process;
* ``recoveries`` — bounded replays/suppressions/restarts that restored the
  fault-free behavior;
* ``swaps`` — FIFO→reorder-buffer hot-swaps (degraded but still correct),
  with the slot cost of giving up the stream discipline;
* ``spills`` — capacity-exhausted channels spilled to unbounded, with the
  planned-vs-effective accounting;
* ``unrecovered`` — faults the guards could only *name*, never silently
  absorb (budget exhausted, snapshot window passed, watchdog spent);
* ``undetected`` — injected faults no guard observed (a validation failure:
  the matrix in `resilience.validate` fails the run on any).

``status`` collapses the ladder: ``clean`` → ``recovered`` → ``degraded``
→ ``unrecovered``.  The report serializes into `AnalysisReport` (schema
v4, ``"resilience"`` field) and renders in the selftimed CLI.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

#: report statuses, best first — a run's status is its worst event
STATUSES = ("clean", "recovered", "degraded", "unrecovered")


@dataclass
class ResilienceReport:
    """Detection/recovery/degradation account of one guarded execution."""

    kernel: str
    policy: str
    plan: Dict[str, Any]                      # FaultPlan.as_dict()
    injected: List[Dict[str, Any]] = field(default_factory=list)
    detections: List[Dict[str, Any]] = field(default_factory=list)
    recoveries: List[Dict[str, Any]] = field(default_factory=list)
    swaps: List[Dict[str, Any]] = field(default_factory=list)
    spills: List[Dict[str, Any]] = field(default_factory=list)
    unrecovered: List[Dict[str, Any]] = field(default_factory=list)
    undetected: List[Dict[str, Any]] = field(default_factory=list)
    watchdog: Dict[str, Any] = field(default_factory=dict)
    completed: bool = False
    #: guard observations made (pops+pushes tagged) — the denominator for
    #: overhead accounting in bench_faults
    guard_events: int = 0
    #: delivered-output streams equal to the fault-free oracle's (None when
    #: no oracle run was available for comparison)
    outputs_match: Optional[bool] = None

    @property
    def status(self) -> str:
        if self.unrecovered or self.undetected or not self.completed:
            return "unrecovered"
        if self.outputs_match is False:
            return "unrecovered"      # silent corruption is the worst case
        if self.swaps or self.spills:
            return "degraded"
        if self.recoveries or self.detections:
            return "recovered"
        return "clean"

    @property
    def detected_all(self) -> bool:
        return not self.undetected

    def as_dict(self) -> Dict[str, Any]:
        return {
            "kernel": self.kernel, "policy": self.policy,
            "status": self.status, "plan": self.plan,
            "injected": list(self.injected),
            "detections": list(self.detections),
            "recoveries": list(self.recoveries),
            "swaps": list(self.swaps), "spills": list(self.spills),
            "unrecovered": list(self.unrecovered),
            "undetected": list(self.undetected),
            "watchdog": dict(self.watchdog),
            "completed": self.completed,
            "guard_events": self.guard_events,
            "outputs_match": self.outputs_match,
            "counts": {"injected": len(self.injected),
                       "detected": len(self.detections),
                       "recovered": len(self.recoveries),
                       "swapped": len(self.swaps),
                       "spilled": len(self.spills),
                       "unrecovered": len(self.unrecovered),
                       "undetected": len(self.undetected)},
        }

    def summary(self) -> str:
        w = self.watchdog or {}
        return (f"{self.kernel} [{self.policy}] resilience: {self.status} — "
                f"{len(self.injected)} injected, "
                f"{len(self.detections)} detected, "
                f"{len(self.recoveries)} recovered, "
                f"{len(self.swaps)} swapped, {len(self.spills)} spilled, "
                f"{len(self.unrecovered)} unrecovered "
                f"(watchdog {w.get('ticks', 0)}/{w.get('limit', 0)} ticks)")

    def render(self) -> str:
        out = [self.summary()]
        if self.injected:
            out.append("  injected:")
            out += [f"    {e['spec']}" for e in self.injected]
        if self.detections:
            out.append("  detected:")
            out += [f"    {e['violation']:12s} on {e['target']} "
                    f"via {e['mechanism']}" for e in self.detections]
        if self.recoveries:
            out.append("  recovered:")
            out += [f"    {e['action']:12s} on {e['target']} "
                    f"(attempt {e['attempts']})" for e in self.recoveries]
        for e in self.swaps:
            out.append(f"  hot-swap: {e['channel']} {e['from']} -> "
                       f"{e['to']} (stream slots {e['stream_slots']}, "
                       f"addressable high-water {e['addressable_slots']})")
        for e in self.spills:
            out.append(f"  spill: {e['channel']} capacity "
                       f"{e['capacity']} -> unbounded "
                       f"(planned {e['planned']}, occupancy "
                       f"{e['occupancy']})")
        for e in self.unrecovered:
            out.append(f"  UNRECOVERED: {e['violation']} on {e['target']} "
                       f"— {e['detail']}")
        for e in self.undetected:
            out.append(f"  UNDETECTED: {e['spec']}")
        return "\n".join(out)
