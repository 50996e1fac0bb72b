"""Observability artifacts of a self-timed run.

Everything the engine measures lands in one `SelfTimedReport`:

* per-channel occupancy high-water marks and stall attribution (how many
  times a process parked — or, under the ``"concurrent"`` policy, how many
  process-steps it spent parked — because this channel was empty / full);
* per-process fire/stall timelines (first/last fire, fire count, stalls
  broken down by channel, and an optional per-step character timeline);
* throughput (fires per step) and the **critical cycle** — the strongly
  connected component of the process graph whose channels absorbed the most
  stall time;
* on deadlock, a `DeadlockInfo`: the blocked set, the blocking cycle in the
  wait-for graph, and the culprit channel.

The report serializes into `AnalysisReport` (``"selftimed"`` field, schema
v3) via `as_dict` and renders for humans via `render` (the
``python -m repro_torch.runtime.selftimed --report`` CLI).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ChannelStats:
    """One bounded channel's observed behavior."""

    name: str
    capacity: Optional[int]         # None = unbounded (ample) run
    values: int                     # distinct tokens the producer emits
    pushes: int                     # tokens actually pushed before stopping
    high_water: int                 # peak occupancy observed
    stall_empty: int = 0            # consumer parked: no token available
    stall_full: int = 0             # producer parked: no free slot

    @property
    def stalls(self) -> int:
        return self.stall_empty + self.stall_full

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "capacity": self.capacity,
                "values": self.values, "pushes": self.pushes,
                "high_water": self.high_water,
                "stall_empty": self.stall_empty,
                "stall_full": self.stall_full}


@dataclass
class ProcessStats:
    """One process's fire/stall account."""

    name: str
    instances: int
    fires: int = 0
    first_fire: int = -1            # step of first fire (-1: never fired)
    last_fire: int = -1
    stall_in: int = 0               # parked waiting for a token
    stall_out: int = 0              # parked waiting for a slot
    #: scheduling opportunities the actor refused (`EngineHooks.fire_allowed`
    #: returned False) — the observable signature of a stalled/crashed actor
    #: that the resilience watchdog attributes faults by.  Always 0 without
    #: hooks.
    denials: int = 0
    stall_channels: Dict[str, int] = field(default_factory=dict)

    @property
    def stalls(self) -> int:
        return self.stall_in + self.stall_out

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "instances": self.instances,
                "fires": self.fires, "first_fire": self.first_fire,
                "last_fire": self.last_fire, "stall_in": self.stall_in,
                "stall_out": self.stall_out, "denials": self.denials,
                "stall_channels": dict(self.stall_channels)}


@dataclass
class DeadlockInfo:
    """Structural deadlock evidence: no process can fire, tokens pending.

    ``cycle`` is the blocking cycle in the wait-for graph (a blocked process
    waits on the producer of its empty input / the consumer of its full
    output); ``culprit`` names the channel whose capacity binds — the full
    channel of smallest capacity on the cycle, or the starved channel when
    the chain ends in a finished process (malformed dataflow)."""

    step: int
    fires: int
    pending: int                    # instances that never fired
    blocked: List[Dict[str, Any]]   # {process, kind, channel, occupancy, capacity}
    cycle: List[Dict[str, Any]]     # same entries, the blocking cycle only
    culprit: Optional[str]

    def cycle_channels(self) -> List[str]:
        return [e["channel"] for e in self.cycle]

    def summary(self) -> str:
        path = " -> ".join(f"{e['process']}[{e['kind']}:{e['channel']}"
                           f" {e['occupancy']}/{e['capacity']}]"
                           for e in self.cycle) or "no cycle (starvation)"
        return (f"deadlock at step {self.step} after {self.fires} fires, "
                f"{self.pending} instances pending; blocking cycle: {path}; "
                f"culprit channel: {self.culprit}")

    def as_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "fires": self.fires,
                "pending": self.pending, "blocked": list(self.blocked),
                "cycle": list(self.cycle), "culprit": self.culprit}


@dataclass
class SelfTimedReport:
    """The artifact of one self-timed execution."""

    kernel: str
    policy: str                     # "sequential" | "concurrent"
    steps: int
    fires: int
    total_instances: int
    completed: bool
    cyclic: bool                    # process graph has a cycle
    channels: List[ChannelStats]
    processes: List[ProcessStats]
    deadlock: Optional[DeadlockInfo] = None
    critical_cycle: Optional[Dict[str, Any]] = None
    timeline: Optional[Dict[str, str]] = None   # per-process step chars
    #: processes that fired below the running max joint rank (sequential
    #: policy only) — the linearization could not serialize them, so their
    #: adjacent channels' high-water marks may differ from the trace
    #: simulator's exact peaks.  Empty for a fully linearized run.
    out_of_order: List[str] = field(default_factory=list)

    @property
    def throughput(self) -> float:
        """Fires per step — 1.0 under the sequential policy by construction,
        the degree of overlap under the concurrent policy."""
        return self.fires / self.steps if self.steps else 0.0

    @property
    def total_stalls(self) -> int:
        return sum(p.stalls for p in self.processes)

    @property
    def stall_ratio(self) -> float:
        """Stalled process-steps over scheduled process-steps."""
        denom = self.fires + self.total_stalls
        return self.total_stalls / denom if denom else 0.0

    def high_water(self) -> Dict[str, int]:
        return {c.name: c.high_water for c in self.channels}

    def channel(self, name: str) -> ChannelStats:
        for c in self.channels:
            if c.name == name:
                return c
        raise KeyError(name)

    def stalls_on(self, name: str) -> int:
        return self.channel(name).stalls

    def as_dict(self) -> Dict[str, Any]:
        return {
            "kernel": self.kernel, "policy": self.policy,
            "steps": self.steps, "fires": self.fires,
            "total_instances": self.total_instances,
            "completed": self.completed, "cyclic": self.cyclic,
            "throughput": round(self.throughput, 4),
            "stall_ratio": round(self.stall_ratio, 4),
            "channels": [c.as_dict() for c in self.channels],
            "processes": [p.as_dict() for p in self.processes],
            "deadlock": (None if self.deadlock is None
                         else self.deadlock.as_dict()),
            "critical_cycle": self.critical_cycle,
            "out_of_order": list(self.out_of_order),
        }

    def summary(self) -> str:
        state = "completed" if self.completed else "DEADLOCK"
        return (f"{self.kernel} [{self.policy}]: {state} — "
                f"{self.fires}/{self.total_instances} fires in "
                f"{self.steps} steps (throughput {self.throughput:.2f}, "
                f"stall {100 * self.stall_ratio:.1f}%)")

    def render(self) -> str:
        """Multi-section human rendering (the ``--report`` CLI output)."""
        out = [self.summary(), "", "channels:"]
        out.append(f"  {'name':40s} {'cap':>5s} {'high':>5s} {'push':>6s} "
                   f"{'st.in':>6s} {'st.out':>6s}")
        for c in self.channels:
            cap = "inf" if c.capacity is None else str(c.capacity)
            out.append(f"  {c.name:40s} {cap:>5s} {c.high_water:5d} "
                       f"{c.pushes:6d} {c.stall_empty:6d} {c.stall_full:6d}")
        out.append("")
        out.append("processes:")
        out.append(f"  {'name':24s} {'fires':>7s} {'first':>6s} {'last':>6s} "
                   f"{'st.in':>6s} {'st.out':>6s}")
        for p in self.processes:
            out.append(f"  {p.name:24s} {p.fires:7d} {p.first_fire:6d} "
                       f"{p.last_fire:6d} {p.stall_in:6d} {p.stall_out:6d}")
        if self.critical_cycle is not None:
            cc = self.critical_cycle
            out.append("")
            out.append(f"critical cycle ({' -> '.join(cc['processes'])}), "
                       f"{cc['stalls']} stalls:")
            for c in cc["channels"]:
                out.append(f"  {c['name']:40s} cap {c['capacity']} "
                           f"high {c['high_water']} stalls {c['stalls']}")
        if self.deadlock is not None:
            out.append("")
            out.append(self.deadlock.summary())
        if self.timeline:
            out.append("")
            out.append("timeline (F fire, i wait-token, o wait-slot, . done):")
            width = max(len(n) for n in self.timeline)
            for name, line in self.timeline.items():
                out.append(f"  {name:{width}s} |{line}|")
        return "\n".join(out)
