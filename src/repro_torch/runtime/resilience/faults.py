"""Declarative, seeded, reproducible fault plans for the PPN runtime.

A `Fault` is one thing going wrong at one place at one chosen moment:

======== ========== ==================================================
kind     target     meaning
======== ========== ==================================================
drop     channel    the token pushed at wire position ``at`` is lost
                    in flight (the producer advances, the consumer
                    starves on it)
duplicate channel   the token at wire position ``at`` arrives twice —
                    the second copy holds a queue slot but is never a
                    legal head
reorder  channel    the tokens at wire positions ``at`` and ``at+1``
                    swap on the wire (a FIFO's internal order
                    scrambled)
corrupt  channel    the payload of the token at wire position ``at``
                    is corrupted (``arg`` = value delta, default +1)
stall    process    once the actor has fired ``at`` times it refuses
                    work until ``span`` more network fires (or idle
                    watchdog rounds) elapse
crash    process    as stall, but the actor never resumes on its own —
                    only a watchdog restart brings it back
capacity channel    at wire position ``at`` the channel loses slots:
                    its capacity drops to ``arg`` (default 0)
======== ========== ==================================================

Triggers are *fire-counts* (wire position = the producer's push index on
that channel; stall/crash = the actor's own fire count), so a plan is
deterministic and schedule-independent — the same plan replayed against
the same network injects the same faults, whatever the policy.

`FaultPlan` bundles faults with the bounded-recovery budgets the guards
honor (snapshot window, replay attempts, watchdog limit) and a ``seed``
that makes `FaultPlan.random` reproducible.

The same vocabulary injects at the *trace* level: `faulted_trace` rewrites
a `ChannelTrace`'s pop sequence the way the fault would scramble the wire,
for replay through the reference / cuda channel implementations.
"""
from __future__ import annotations

import random as _random
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..simulator import ChannelTrace

DROP = "drop"
DUPLICATE = "duplicate"
REORDER = "reorder"
CORRUPT = "corrupt"
STALL = "stall"
CRASH = "crash"
CAPACITY = "capacity"

#: faults that target a token on a channel
TOKEN_KINDS: Tuple[str, ...] = (DROP, DUPLICATE, REORDER, CORRUPT)
#: faults that target an actor
PROCESS_KINDS: Tuple[str, ...] = (STALL, CRASH)
#: faults that target a channel (token faults + capacity loss)
CHANNEL_KINDS: Tuple[str, ...] = TOKEN_KINDS + (CAPACITY,)
ALL_KINDS: Tuple[str, ...] = TOKEN_KINDS + PROCESS_KINDS + (CAPACITY,)


class FaultSpecError(ValueError):
    """A fault spec string / plan could not be understood."""


@dataclass(frozen=True)
class Fault:
    """One declaratively scheduled fault (see module docstring)."""

    kind: str
    target: str                   # channel name (channel kinds) or process
    at: int = 0                   # trigger fire-count / wire position
    span: int = 4                 # stall length (network fires or idle rounds)
    arg: Optional[int] = None     # corrupt: payload delta; capacity: new cap

    def __post_init__(self):
        if self.kind not in ALL_KINDS:
            raise FaultSpecError(f"unknown fault kind {self.kind!r} "
                                 f"(one of {', '.join(ALL_KINDS)})")
        if self.at < 0:
            raise FaultSpecError(f"{self.kind}:{self.target}: trigger "
                                 f"@{self.at} must be >= 0")

    @property
    def on_process(self) -> bool:
        return self.kind in PROCESS_KINDS

    def spec(self) -> str:
        s = f"{self.kind}:{self.target}@{self.at}"
        if self.kind in (STALL, CRASH) and self.span != 4:
            s += f"*{self.span}"
        elif self.arg is not None:
            s += f"*{self.arg}"
        return s

    def as_dict(self) -> Dict[str, object]:
        return {"kind": self.kind, "target": self.target, "at": self.at,
                "span": self.span, "arg": self.arg, "spec": self.spec()}


def parse_fault(spec: str) -> Fault:
    """Parse ``KIND:TARGET[@AT][*N]`` — ``N`` is the stall span for
    stall/crash, the payload delta for corrupt, the surviving capacity for
    capacity loss.  Target names may contain anything but ``@`` (channel
    names like ``a->b.x[0]`` are fine)."""
    if ":" not in spec:
        raise FaultSpecError(
            f"bad fault spec {spec!r} — expected KIND:TARGET[@AT][*N], "
            f"e.g. drop:a->b.x[0]@5 or stall:compute@3*8")
    kind, rest = spec.split(":", 1)
    at, n = 0, None
    if "@" in rest:
        rest, trig = rest.rsplit("@", 1)
        if "*" in trig:
            trig, ns = trig.rsplit("*", 1)
            try:
                n = int(ns)
            except ValueError:
                raise FaultSpecError(f"bad *N in fault spec {spec!r}") \
                    from None
        try:
            at = int(trig)
        except ValueError:
            raise FaultSpecError(f"bad @AT in fault spec {spec!r}") from None
    if not rest:
        raise FaultSpecError(f"bad fault spec {spec!r} — empty target")
    kw: Dict[str, int] = {}
    if n is not None:
        if kind in PROCESS_KINDS:
            kw["span"] = n
        else:
            kw["arg"] = n
    return Fault(kind=kind, target=rest, at=at, **kw)


@dataclass(frozen=True)
class FaultPlan:
    """A reproducible set of faults plus the recovery budgets guards honor.

    ``snapshot_window`` — per-channel replay log depth (most recent sends);
    ``max_replays`` — bounded token-replay attempts per channel (the
    `train.ft.retrying` idiom: give up loudly, never retry forever);
    ``max_restarts`` — crashed-actor restarts the watchdog will grant;
    ``watchdog_limit`` — quiesce interventions before the watchdog declares
    the run unrecoverable (the bound that guarantees no hang)."""

    faults: Tuple[Fault, ...] = ()
    seed: int = 0
    snapshot_window: int = 16
    max_replays: int = 4
    max_restarts: int = 1
    watchdog_limit: int = 64

    @classmethod
    def parse(cls, specs: Sequence[str], **kw) -> "FaultPlan":
        return cls(faults=tuple(parse_fault(s) for s in specs), **kw)

    @classmethod
    def single(cls, kind: str, target: str, at: int = 0, **kw) -> "FaultPlan":
        extra = {k: kw.pop(k) for k in ("span", "arg") if k in kw}
        return cls(faults=(Fault(kind, target, at, **extra),), **kw)

    @classmethod
    def random(cls, ppn, seed: int = 0,
               kinds: Sequence[str] = ALL_KINDS) -> "FaultPlan":
        """One random single-fault plan for ``ppn``, deterministic in
        ``seed``: a kind, a live target of the right species, and a trigger
        inside the target's actual activity range."""
        rng = _random.Random(seed)
        chans = []
        for ch in ppn.channels:
            if ch.num_edges == 0:
                continue
            nv = (len(np.unique(ch.src_pts, axis=0))
                  if ch.src_pts.ndim == 2 else ch.num_edges)
            chans.append((ch.name, max(1, int(nv))))
        procs = [(p.name, len(p.pts)) for p in ppn.processes.values()
                 if len(p.pts) > 0]
        kind = rng.choice([k for k in kinds
                           if (procs if k in PROCESS_KINDS else chans)])
        if kind in PROCESS_KINDS:
            name, n = rng.choice(procs)
            at = rng.randrange(n)
            return cls(faults=(Fault(kind, name, at,
                                     span=rng.randrange(1, 5)),), seed=seed)
        name, nv = rng.choice(chans)
        hi = max(1, nv - 1 if kind == REORDER else nv)
        at = rng.randrange(hi)
        arg = rng.randrange(1, 7) if kind == CORRUPT else (
            0 if kind == CAPACITY else None)
        return cls(faults=(Fault(kind, name, at, arg=arg),), seed=seed)

    def for_channel(self, name: str) -> List[Fault]:
        return [f for f in self.faults
                if not f.on_process and f.target == name]

    def for_process(self, name: str) -> List[Fault]:
        return [f for f in self.faults if f.on_process and f.target == name]

    def validate_against(self, channel_names: Sequence[str],
                         process_names: Sequence[str]) -> None:
        """Every fault must name a real target of the right species."""
        cset, pset = set(channel_names), set(process_names)
        for f in self.faults:
            pool = pset if f.on_process else cset
            what = "process" if f.on_process else "channel"
            if f.target not in pool:
                raise FaultSpecError(
                    f"{f.spec()}: no {what} named {f.target!r}")

    def as_dict(self) -> Dict[str, object]:
        return {"faults": [f.as_dict() for f in self.faults],
                "seed": self.seed,
                "snapshot_window": self.snapshot_window,
                "max_replays": self.max_replays,
                "max_restarts": self.max_restarts,
                "watchdog_limit": self.watchdog_limit}


# ------------------------------------------------------- trace-level faults --

def faulted_trace(trace: ChannelTrace, fault: Fault) -> ChannelTrace:
    """Rewrite a channel trace's pop stream the way ``fault`` would scramble
    the wire, keeping the per-edge arrays coherent (pop order is sorted
    consumer rank; the per-edge write ranks are re-derived from the faulted
    pops).  Capacity/process faults have no trace-level form and raise."""
    if fault.kind not in TOKEN_KINDS:
        raise FaultSpecError(f"{fault.kind!r} has no trace-level form "
                             f"(token kinds: {', '.join(TOKEN_KINDS)})")
    if trace.num_edges == 0:
        return trace
    pops = trace.pops.copy()
    r_sorted = np.sort(trace.r_rank, kind="stable")
    at = min(fault.at, len(pops) - 1)
    if fault.kind == DROP:
        # the pop of the token pushed at position `at` never happens
        hit = np.flatnonzero(pops == at)
        keep = np.ones(len(pops), dtype=bool)
        if len(hit):
            keep[hit[0]] = False
        pops, r_sorted = pops[keep], r_sorted[keep]
    elif fault.kind == DUPLICATE:
        hit = np.flatnonzero(pops == at)
        i = int(hit[0]) if len(hit) else at
        pops = np.insert(pops, i + 1, pops[i])
        r_sorted = np.insert(r_sorted, i + 1, r_sorted[i])
    elif fault.kind == REORDER:
        i = min(at, len(pops) - 2)
        if i < 0:
            return trace
        pops[i], pops[i + 1] = pops[i + 1], pops[i]
    else:                             # CORRUPT: a pop reads the wrong slot
        delta = fault.arg if fault.arg else 1
        pops[at] = (pops[at] + delta) % trace.num_values
    order = np.argsort(trace.value_wrank, kind="stable")
    wrank_by_pos = trace.value_wrank[order]
    return replace(trace, num_edges=len(pops), pops=pops,
                   r_rank=r_sorted, w_rank=wrank_by_pos[pops])


#: per-value expected pop multiplicity of an unfaulted trace — the guard's
#: ground truth for the multiset audit (`guards.audit_trace`)
def expected_pop_counts(trace: ChannelTrace) -> np.ndarray:
    return np.bincount(trace.pops, minlength=trace.num_values)
