"""`Analysis.validate(mode="selftimed")` — execute the planned network.

The trace-mode validation replays channels one at a time against a fixed
linearization; this mode runs the whole network *concurrently executable*:
every channel a bounded queue at its planned capacity, every process firing
on data availability alone.  Checks:

* **completion** — the network must run to quiescence with every instance
  fired under the planned capacities.  For cyclic PPNs (pipeline wraparound,
  decode feedback) this is the check nothing else in the repo performs: the
  planned slots are *observed* to be deadlock-free, not assumed.
* **occupancy cross-check** — under the sequential (global-rank priority)
  policy the execution replays the sizing model's linearization whenever
  nothing blocks, so per-channel high-water marks must EQUAL the trace
  simulator's exact peaks — and always fit the planned slots.  Channels the
  linearization cannot serialize (``late_edges``) and channels adjacent to a
  process the engine observed firing out of joint-rank order (the fallout
  of those late edges) are exempt from the equality — their real schedule
  is not the linearization.  The root exemption set is shared with trace
  replay via `simulator.channel_late_edges`.  Late channels additionally
  run *unbounded*: their planned size bounds a schedule they do not run
  (atax's fully-late ``tupd->yupd.tmp[1]`` genuinely deadlocks at its
  linearized peak of one slot), so the engine instead measures their real
  self-timed demand and reports it (``measured``).
* **negative direction** (cyclic nets) — shrinking any cycle channel's
  capacity by one slot must be *observed*: either structural deadlock whose
  blocking cycle names the shrunk channel, or a stall-bound slowdown (more
  steps than the planned-capacity concurrent baseline, with stalls
  attributed to the shrunk channel).  A shrink nobody notices means the
  planned capacity was not actually load-bearing — a sizing bug.

Raises `runtime.validate.ValidationError` (the same contract as trace mode)
on any contradiction; otherwise returns the evidence as a
`SelfTimedValidation`, embedded in `AnalysisReport` under ``"selftimed"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from ...core.sizing import _channel_capacity, pow2_size
from ..simulator import channel_late_edges
from ..validate import ValidationError
from .engine import cycle_channels, execute_ppn
from .observe import SelfTimedReport


def planned_capacities(analysis) -> Dict[str, int]:
    """Per-channel slot counts the analysis planned: plan records when
    `.plan()` ran, `.size()` slots when sized, else the pow2 capacities the
    size stage would produce.

    Channels the linearization ranks read-before-write throughout (every
    edge late) get a planned size of 0 — the sequential sweep never sees a
    live value.  A self-timed token still needs somewhere to sit between
    its push and its pop, so executable capacities floor at one slot."""
    ppn = analysis.ppn
    if analysis.plans is not None:
        caps = {p.name: int(p.buffer_slots) for p in analysis.plans}
    elif analysis.sizes is not None:
        caps = {name: int(s) for name, s in analysis.sizes.items()}
    else:
        szctx = analysis.ctx.sizing(ppn)
        caps = {ch.name: pow2_size(_channel_capacity(ppn, ch, context=szctx))
                for ch in ppn.channels}
    return {name: max(1, s) for name, s in caps.items()}


def executable_capacities(analysis) -> Dict[str, Optional[int]]:
    """`planned_capacities` adjusted for execution: channels the
    linearization cannot serialize (late edges) run unbounded — their
    planned size bounds a schedule they do not run, and holding them to it
    can genuinely deadlock (atax) — so the engine measures their demand
    instead.  Every serializable channel keeps its planned slots."""
    ppn = analysis.ppn
    caps = planned_capacities(analysis)
    late = channel_late_edges(ppn, analysis.ctx.sizing(ppn))
    return {name: (None if late.get(name, 0) else s)
            for name, s in caps.items()}


@dataclass
class SelfTimedValidation:
    """The selftimed stage's evidence (embedded in `AnalysisReport`)."""

    kernel: str
    report: SelfTimedReport            # sequential-policy positive run
    exact: Dict[str, int]              # trace simulator's exact peaks
    late: Dict[str, int]               # shared exemption set (late edges)
    exempt: List[str]                  # channels exempt from peak equality
    #: late channels run unbounded (the linearized size is no bound on the
    #: self-timed schedule — atax's ``tupd->yupd.tmp[1]`` genuinely needs
    #: more slots than its linearized peak); this is their MEASURED
    #: self-timed demand, the number the trace model cannot produce.
    measured: Dict[str, int] = field(default_factory=dict)
    negative: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def cyclic(self) -> bool:
        return self.report.cyclic

    @property
    def exact_matches(self) -> int:
        hw = self.report.high_water()
        return sum(1 for name, cap in self.exact.items()
                   if name not in self.exempt and hw.get(name) == cap)

    def as_dict(self) -> Dict[str, Any]:
        return {"mode": "selftimed", "completed": self.report.completed,
                "cyclic": self.cyclic,
                "exact_matches": self.exact_matches,
                "late": dict(self.late), "exempt": list(self.exempt),
                "measured": dict(self.measured),
                "negative": list(self.negative),
                "report": self.report.as_dict()}

    def summary(self) -> str:
        neg = ""
        if self.negative:
            kinds = [n["observed"] for n in self.negative]
            neg = (f"; {len(self.negative)} capacity shrinks observed "
                   f"({kinds.count('deadlock')} deadlock, "
                   f"{kinds.count('slowdown')} slowdown)")
        return (f"{self.kernel}: self-timed {self.report.summary()}; "
                f"{self.exact_matches} channel peaks match the trace "
                f"simulator exactly ({len(self.exempt)} exempt){neg}")


def selftimed_validate(analysis, record_timeline: bool = False
                       ) -> SelfTimedValidation:
    """Run the self-timed checks for ``analysis``; returns the evidence,
    raises `ValidationError` on any contradiction."""
    ppn = analysis.ppn
    szctx = analysis.ctx.sizing(ppn)
    late = channel_late_edges(ppn, szctx)
    exec_caps = executable_capacities(analysis)
    failures: List[str] = []

    rep = execute_ppn(ppn, exec_caps, policy="sequential",
                      record_timeline=record_timeline, on_deadlock="report")
    if not rep.completed:
        assert rep.deadlock is not None
        raise ValidationError(ppn.kernel_name, [
            f"planned capacities deadlock the network: "
            f"{rep.deadlock.summary()}"])

    exact = {ch.name: _channel_capacity(ppn, ch, context=szctx)
             for ch in ppn.channels if ch.num_edges}
    # parking alone does not deviate from the linearization (the sequential
    # policy still fires in joint-rank order); only processes the engine
    # observed firing BELOW the running max rank did.  Their adjacent
    # channels — and late-edge channels, the root cause of any such
    # reordering — are exempt from peak equality but stay capacity-bounded.
    deviant = set(rep.out_of_order)
    exempt = sorted(
        ch.name for ch in ppn.channels if ch.num_edges and (
            late.get(ch.name, 0) > 0
            or ch.producer in deviant or ch.consumer in deviant))

    measured = {cs.name: cs.high_water for cs in rep.channels
                if late.get(cs.name, 0) > 0}
    for cs in rep.channels:
        cap = exec_caps.get(cs.name)
        if cap is not None and cs.high_water > cap:
            failures.append(f"{cs.name}: high-water {cs.high_water} exceeds "
                            f"the {cap} planned slots")
        if cs.name not in exempt and cs.high_water != exact[cs.name]:
            failures.append(
                f"{cs.name}: self-timed high-water {cs.high_water} != trace "
                f"simulator exact peak {exact[cs.name]} — the replay "
                f"diverged from the linearization without blocking")

    negative: List[Dict[str, Any]] = []
    cyc = cycle_channels(ppn)
    if cyc:
        base = execute_ppn(ppn, exec_caps, policy="concurrent",
                           on_deadlock="report")
        if not base.completed:
            assert base.deadlock is not None
            raise ValidationError(ppn.kernel_name, [
                f"planned capacities deadlock the concurrent policy: "
                f"{base.deadlock.summary()}"])
        for name in cyc:
            slots = exec_caps.get(name)
            if slots is None or slots < 1:
                continue
            # pow2 planning may pad above the channel's real demand, making
            # planned−1 a semantic no-op; the load-bearing boundary is the
            # observed high-water, so shrink one slot below whichever is
            # smaller.
            target = min(slots, base.channel(name).high_water) - 1
            if target < 0:
                continue
            shrunk = dict(exec_caps)
            shrunk[name] = target
            r2 = execute_ppn(ppn, shrunk, policy="concurrent",
                             on_deadlock="report")
            outcome: Dict[str, Any] = {"channel": name, "slots": slots,
                                       "shrunk_to": target}
            if not r2.completed:
                assert r2.deadlock is not None
                outcome["observed"] = "deadlock"
                outcome["culprit"] = r2.deadlock.culprit
                outcome["cycle"] = r2.deadlock.cycle_channels()
                implicated = set(outcome["cycle"]) | {r2.deadlock.culprit} \
                    | {b["channel"] for b in r2.deadlock.blocked}
                if name not in implicated:
                    failures.append(
                        f"{name}: shrinking to {target} slots deadlocked "
                        f"but the report blames {sorted(implicated)} — the "
                        f"culprit channel is not named")
            elif (r2.stalls_on(name) > base.stalls_on(name)
                  or r2.steps > base.steps):
                outcome["observed"] = "slowdown"
                outcome["steps"] = r2.steps
                outcome["baseline_steps"] = base.steps
                outcome["stalls"] = r2.stalls_on(name)
            else:
                failures.append(
                    f"{name}: shrinking the planned {slots} slots to "
                    f"{target} went unobserved (steps {r2.steps} vs "
                    f"baseline {base.steps}, {r2.stalls_on(name)} stalls) — "
                    f"the planned capacity is not load-bearing")
                outcome["observed"] = "nothing"
            negative.append(outcome)

    if failures:
        raise ValidationError(ppn.kernel_name, failures)
    return SelfTimedValidation(ppn.kernel_name, rep, exact, late, exempt,
                               measured, negative)
