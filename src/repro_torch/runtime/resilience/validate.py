"""`Analysis.validate(mode="faults")` — the fault matrix.

For one analyzed kernel this stage proves, operationally, the resilience
contract the guards claim:

* **no false positives** — a guarded fault-free run must come back
  ``clean`` (guards armed on every channel, zero detections) and its
  delivered-payload streams become the oracle;
* **engine matrix** — for representative targets (a stream-lowered
  channel, a broadcast-register channel, an addressable channel, a
  producing actor) each applicable fault kind is injected into a guarded
  self-timed execution; every fault must be **detected**, and the run must
  either **recover/degrade with outputs equal to the oracle** or come back
  **unrecovered with the culprit named** — never a silent wrong answer,
  never a hang (the watchdog bounds recovery, the engine detects deadlock
  structurally);
* **trace matrix** — the same token faults injected at the wire level
  (`faulted_trace`) must be rejected by the guarded channel
  implementations (`guarded_replay`: order discipline + multiset audit) on
  the reference backend — and identically on the cuda ring backend, whose
  replay is kernel 3 (``csrc/replay.cu``) on the card.

The evidence is a `ResilienceValidation` (embedded in `AnalysisReport`
under ``"resilience"``, schema v4); contradictions raise the shared
`runtime.validate.ValidationError`.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..lowering import (BROADCAST_REGISTER, REORDER_BUFFER, STREAM_LOWERINGS,
                        backend, lowering_for_pattern)
from ..simulator import ChannelTrace, trace_channel
from ..validate import ValidationError
from ..selftimed.validate import executable_capacities
from .faults import (CAPACITY, CORRUPT, CRASH, DROP, DUPLICATE, REORDER,
                     STALL, Fault, FaultPlan, expected_pop_counts,
                     faulted_trace)
from .guards import GuardViolation, guarded_replay, mode_for_lowering
from .harness import run_guarded

#: engine-level kinds exercised per guard mode of the target channel
ENGINE_KINDS = {"fifo": (DROP, DUPLICATE, REORDER, CORRUPT, CAPACITY),
                "register": (REORDER, CORRUPT),
                "reorder": (DROP, CORRUPT)}

#: trace-level kinds that violate each guard mode's contract (an
#: addressable buffer legally serves any pop order, so only conservation
#: faults are detectable there — and at trace level a corrupt is a
#: misaddressed pop, which conservation does catch)
TRACE_KINDS = {"fifo": (DROP, DUPLICATE, REORDER, CORRUPT),
               "register": (DROP, DUPLICATE, REORDER),
               "reorder": (DROP, DUPLICATE, CORRUPT)}


@dataclass
class ResilienceValidation:
    """The fault-matrix evidence (embedded in `AnalysisReport`)."""

    kernel: str
    clean: Dict[str, Any]              # oracle run: status + summary
    matrix: List[Dict[str, Any]] = field(default_factory=list)
    trace_matrix: List[Dict[str, Any]] = field(default_factory=list)
    trace_backends: List[str] = field(default_factory=list)

    @property
    def injected(self) -> int:
        return len(self.matrix) + len(self.trace_matrix)

    @property
    def recovered(self) -> int:
        return sum(1 for r in self.matrix
                   if r["status"] in ("recovered", "degraded"))

    def as_dict(self) -> Dict[str, Any]:
        return {"mode": "faults", "kernel": self.kernel,
                "clean": dict(self.clean),
                "matrix": list(self.matrix),
                "trace_matrix": list(self.trace_matrix),
                "trace_backends": list(self.trace_backends),
                "counts": {"injected": self.injected,
                           "engine_cases": len(self.matrix),
                           "trace_cases": len(self.trace_matrix),
                           "recovered": self.recovered}}

    def summary(self) -> str:
        unrec = sum(1 for r in self.matrix if r["status"] == "unrecovered")
        return (f"{self.kernel}: fault matrix green — {len(self.matrix)} "
                f"engine faults ({self.recovered} recovered/degraded, "
                f"{unrec} unrecovered-but-named), "
                f"{len(self.trace_matrix)} wire faults rejected on "
                f"{'/'.join(self.trace_backends)}")


def channel_lowerings(analysis) -> Dict[str, str]:
    """Channel name → lowering, from `.plan()` records when present, else
    the verdict table over (possibly cached) classifications."""
    if analysis.plans is not None:
        return {p.name: p.lowering for p in analysis.plans}
    pats = analysis.patterns
    if pats is None:
        clf = analysis.ctx.classifier(analysis.ppn)
        pats = {ch.name: clf.classify(ch) for ch in analysis.ppn.channels}
    return {name: lowering_for_pattern(p) for name, p in pats.items()}


def _pick_targets(analysis, lowerings: Dict[str, str]) -> Dict[str, Any]:
    """Representative fault targets: the first channel of each guard mode
    with at least 3 tokens, plus the stream producer (an actor that owes
    tokens downstream, so its stall/crash is observable)."""
    ppn = analysis.ppn
    values = {c.name: c for c in ppn.channels}
    picked: Dict[str, Any] = {"channels": {}, "process": None}
    szctx = analysis.ctx.sizing(ppn)
    for ch in ppn.channels:
        if ch.num_edges < 3:
            continue
        low = lowerings.get(ch.name, REORDER_BUFFER)
        mode = mode_for_lowering(low)
        if mode in picked["channels"]:
            continue
        tr = trace_channel(ppn, ch, szctx)
        if tr.num_values < 3:
            continue
        picked["channels"][mode] = {"name": ch.name, "lowering": low,
                                    "values": tr.num_values}
        if picked["process"] is None:
            prod = values[ch.name].producer
            fires = len(ppn.processes[prod].pts)
            if fires >= 3:
                picked["process"] = {"name": prod, "fires": fires}
    if picked["process"] is None:
        for p in ppn.processes.values():
            if len(p.pts) >= 3:
                picked["process"] = {"name": p.name, "fires": len(p.pts)}
                break
    return picked


@dataclass(frozen=True)
class WireFault:
    """One case of the trace matrix: ``fault`` injected into the target
    channel of a guard mode, as the faulted ``trace`` the guarded
    implementation of ``lowering`` must reject, audited against the clean
    trace's pop counts ``expected``."""

    mode: str
    lowering: str
    fault: Fault
    trace: ChannelTrace
    expected: np.ndarray


def wire_faults(analysis, lowerings: Optional[Dict[str, str]] = None,
                targets: Optional[Dict[str, Any]] = None
                ) -> List[WireFault]:
    """The trace matrix's cases, in the order of its rows on one backend:
    for each guard mode's target channel (modes sorted), each of
    ``TRACE_KINDS[mode]`` at wire position ``min(1, values - 1)``, a
    corrupt by +3."""
    ppn = analysis.ppn
    if targets is None:
        targets = _pick_targets(analysis, lowerings
                                or channel_lowerings(analysis))
    szctx = analysis.ctx.sizing(ppn)
    chan_by_name = {c.name: c for c in ppn.channels}
    cases: List[WireFault] = []
    for mode, tgt in sorted(targets["channels"].items()):
        name, nv = tgt["name"], tgt["values"]
        trace = trace_channel(ppn, chan_by_name[name], szctx)
        expected = expected_pop_counts(trace)
        for kind in TRACE_KINDS[mode]:
            fault = Fault(kind, name, min(1, nv - 1),
                          arg=3 if kind == CORRUPT else None)
            cases.append(WireFault(mode, tgt["lowering"], fault,
                                   faulted_trace(trace, fault), expected))
    return cases


def _device_kw(backend_name: str, lowering: str, device) -> Dict[str, Any]:
    """``{"device": device}`` for a backend whose ``run`` takes one, when
    ``device`` is not None; else nothing (the reference simulator's ``run``
    has no device, and ``None`` leaves a backend's default)."""
    if device is None:
        return {}
    run = backend(backend_name).implementation(lowering).run
    if "device" not in inspect.signature(run).parameters:
        return {}
    return {"device": device}


def faults_validate(analysis, policy: str = "sequential",
                    trace_backends: Sequence[str] = ("reference", "cuda"),
                    device=None) -> ResilienceValidation:
    """Run the fault matrix for ``analysis``; returns the evidence, raises
    `ValidationError` on any contradiction.

    The engine matrix runs on the host.  The trace matrix replays every
    faulted trace on each of ``trace_backends``; on ``"cuda"`` that is
    kernel 3 on ``device`` (``None`` meaning the card, ``"cpu"`` the
    kernel's plain version).  Only a `SimulationError` of a replay counts
    as a detection: a failed build or launch propagates."""
    ppn = analysis.ppn
    caps = executable_capacities(analysis)
    lows = channel_lowerings(analysis)
    failures: List[str] = []

    # -- no false positives: a guarded clean run must be clean
    oracle = run_guarded(ppn, caps, FaultPlan(), lows, policy=policy)
    if oracle.resilience.status != "clean":
        raise ValidationError(ppn.kernel_name, [
            f"guards raised on a fault-free run (false positive): "
            f"{oracle.resilience.summary()}"])
    if not oracle.run.completed:
        raise ValidationError(ppn.kernel_name, [
            "guarded fault-free run did not complete"])

    targets = _pick_targets(analysis, lows)
    matrix: List[Dict[str, Any]] = []

    # -- engine matrix: inject into live guarded executions
    for mode, tgt in sorted(targets["channels"].items()):
        name, nv = tgt["name"], tgt["values"]
        at = min(1, nv - 1)
        for kind in ENGINE_KINDS[mode]:
            arg = 0 if kind == CAPACITY else (3 if kind == CORRUPT else None)
            # size the replay log to the stream so recovery is in reach —
            # the bounded-window give-up path is covered by test_resilience
            plan = FaultPlan(faults=(Fault(kind, name, at, arg=arg),),
                             snapshot_window=nv)
            row = _engine_case(ppn, caps, lows, plan, policy, oracle,
                               f"{kind}:{name}@{at}", failures)
            row.update({"layer": "engine", "mode": mode})
            matrix.append(row)
    if targets["process"] is not None:
        pname = targets["process"]["name"]
        at = min(1, targets["process"]["fires"] - 1)
        for kind in (STALL, CRASH):
            plan = FaultPlan(faults=(Fault(kind, pname, at, span=3),))
            row = _engine_case(ppn, caps, lows, plan, policy, oracle,
                               f"{kind}:{pname}@{at}", failures)
            row.update({"layer": "engine", "mode": "process"})
            matrix.append(row)

    # -- trace matrix: wire-level faults must be rejected in replay
    trace_matrix: List[Dict[str, Any]] = []
    cases = wire_faults(analysis, targets=targets)
    for backend_name in trace_backends:
        for case in cases:
            fault, name = case.fault, case.fault.target
            row = {"layer": "trace", "backend": backend_name,
                   "mode": case.mode, "fault": fault.spec()}
            try:
                guarded_replay(case.trace, case.lowering, backend_name,
                               expected=case.expected,
                               **_device_kw(backend_name, case.lowering,
                                            device))
                failures.append(
                    f"{name}: wire fault {fault.spec()} replayed "
                    f"cleanly on {backend_name}:{case.lowering} — "
                    f"undetected")
                row["detected"] = False
            except GuardViolation as e:
                row["detected"] = True
                row["violation"] = e.violation
                row["mechanism"] = e.mechanism
                if e.channel != name:
                    failures.append(
                        f"{name}: wire fault {fault.spec()} detected "
                        f"but blamed on {e.channel!r}")
            trace_matrix.append(row)

    if failures:
        raise ValidationError(ppn.kernel_name, failures)
    return ResilienceValidation(
        kernel=ppn.kernel_name,
        clean={"status": oracle.resilience.status,
               "guard_events": oracle.resilience.guard_events,
               "summary": oracle.resilience.summary()},
        matrix=matrix, trace_matrix=trace_matrix,
        trace_backends=list(trace_backends))


def _engine_case(ppn, caps, lows, plan: FaultPlan, policy: str, oracle,
                 label: str, failures: List[str]) -> Dict[str, Any]:
    """One engine-level fault case: inject, then hold the run to the
    contract — detected, and recovered-with-oracle-outputs or
    unrecovered-with-named-culprit."""
    gr = run_guarded(ppn, caps, plan, lows, policy=policy, oracle=oracle)
    r = gr.resilience
    f = plan.faults[0]
    row: Dict[str, Any] = {
        "fault": f.spec(), "status": r.status,
        "detected": bool(r.detections), "injected": bool(r.injected),
        "recoveries": len(r.recoveries), "swaps": len(r.swaps),
        "spills": len(r.spills), "outputs_match": r.outputs_match,
        "mechanisms": sorted({d["mechanism"] for d in r.detections}),
    }
    if not r.injected:
        failures.append(f"{label}: fault never triggered — bad matrix "
                        f"target")
        return row
    if r.undetected:
        failures.append(f"{label}: injected but NO guard detected it")
        return row
    if not r.detections:
        failures.append(f"{label}: no detection recorded")
        return row
    if r.status in ("recovered", "degraded"):
        if not r.completed:
            failures.append(f"{label}: status {r.status} but the run did "
                            f"not complete")
        if r.outputs_match is not True:
            failures.append(f"{label}: status {r.status} but delivered "
                            f"outputs differ from the fault-free oracle — "
                            f"silent corruption")
    elif r.status == "unrecovered":
        named = {e["target"] for e in r.unrecovered} | \
                {d["target"] for d in r.detections}
        if f.target not in named:
            failures.append(f"{label}: unrecovered but the culprit "
                            f"{f.target!r} is not named (named: "
                            f"{sorted(named)})")
    else:
        failures.append(f"{label}: fault injected yet the run reports "
                        f"{r.status!r}")
    return row
