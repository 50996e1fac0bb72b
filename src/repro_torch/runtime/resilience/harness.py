"""Guarded self-timed execution: inject faults, detect, recover, degrade.

`ResilienceHooks` plugs into the engine's `EngineHooks` seam and plays both
sides of the game in one deterministic pass:

* the **injector** applies the `FaultPlan` at exact wire positions / fire
  counts (drop, duplicate, reorder, corrupt, stall, crash, capacity loss);
* the **guards** tag every token with its wire position plus a checksum of
  the payload, verify the channel's ordering discipline at every pop, and
  keep a bounded per-channel replay log (`FaultPlan.snapshot_window`);
* **recovery** follows the ladder: suppress a duplicate at the push site,
  replay a corrupted/lost token from the snapshot (bounded by
  ``max_replays``, the `train.ft.retrying` idiom), wait out a stalled actor
  / restart a crashed one (bounded by ``max_restarts``), hot-swap a
  violated FIFO to the addressable reorder buffer
  (`lowering.DEGRADED_LOWERING`) and keep executing, spill an exhausted
  channel to unbounded with accounting;
* the **watchdog** bounds quiesce interventions (`watchdog_limit`) so a
  recovery loop that stops making progress terminates as a *named*
  unrecovered report — never a hang, never a timeout.

Every event lands in a `ResilienceReport`; `run_guarded` is the one entry
point and also produces the delivered-payload streams (pop order per
channel) that `resilience.validate` compares against a fault-free oracle —
the "no silent wrong answer" check.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Mapping, Optional, Tuple

from ..lowering import DEGRADED_LOWERING, REORDER_BUFFER
from ..selftimed.engine import EngineHooks, SelfTimedEngine
from ..selftimed.observe import SelfTimedReport
from .faults import (CAPACITY, CORRUPT, DROP, DUPLICATE, REORDER, STALL,
                     Fault, FaultPlan)
from .guards import ProgressWatchdog, mode_for_lowering
from .report import ResilienceReport


class _ChanGuard:
    """Per-channel guard + injector state (engine channel index scoped)."""

    __slots__ = ("name", "lowering", "mode", "next_seq", "expect",
                 "pending_swap", "tag", "checksum", "payload", "delivered",
                 "snapshot", "replays", "writer_pos", "faults")

    def __init__(self, name: str, lowering: str, window: int):
        self.name = name
        self.lowering = lowering
        self.mode = mode_for_lowering(lowering)
        self.next_seq = 0
        self.expect = 0                 # next tag (fifo) / front tag (reg)
        self.pending_swap: Optional[int] = None
        self.tag: Dict[int, int] = {}
        self.checksum: Dict[int, int] = {}   # v -> true payload (side-band)
        self.payload: Dict[int, int] = {}    # v -> payload as on the wire
        self.delivered: List[int] = []       # payloads served, pop order
        self.snapshot: deque = deque(maxlen=max(1, window))  # replay log
        self.replays = 0
        self.writer_pos: Dict[int, int] = {}
        self.faults: List[List] = []    # [Fault, triggered?] pairs


class ResilienceHooks(EngineHooks):
    """Fault injector + runtime guards over the engine hook seam.

    ``lowerings`` maps channel name → lowering (absent channels are guarded
    addressably); ``recover=False`` detects and reports but never replays
    or suppresses — the detect-only mode bench_faults uses to price
    detection alone."""

    def __init__(self, plan: Optional[FaultPlan] = None,
                 lowerings: Optional[Mapping[str, str]] = None,
                 recover: bool = True):
        self.plan = plan or FaultPlan()
        self.lowerings = dict(lowerings or {})
        self.recover = recover
        self.watchdog = ProgressWatchdog(self.plan.watchdog_limit,
                                         self.plan.max_restarts)
        self.guard_events = 0
        self.injected: List[Dict] = []
        self.detections: List[Dict] = []
        self.recoveries: List[Dict] = []
        self.swaps: List[Dict] = []
        self.spills: List[Dict] = []
        self.unrecovered: List[Dict] = []
        self._detected_targets: set = set()
        self._capacity_planned: Dict[int, Optional[int]] = {}
        self._failed_tokens: set = set()     # (ci, v) already given up on

    # -------------------------------------------------------------- bind --

    def bind(self, engine: SelfTimedEngine) -> None:
        self.engine = engine
        w = self.plan.snapshot_window
        self.chan = [
            _ChanGuard(c.name, self.lowerings.get(c.name, REORDER_BUFFER), w)
            for c in engine.chans]
        for ci, c in enumerate(engine.chans):
            self._capacity_planned[ci] = c.capacity
            for f in self.plan.for_channel(c.name):
                self.chan[ci].faults.append([f, False])
        self._writer_pos_built = False   # built lazily, first quiesce
        self.pstate: Dict[int, Dict] = {}
        pidx = {p.name: i for i, p in enumerate(engine.procs)}
        for f in self.plan.faults:
            if f.on_process and f.target in pidx:
                self.pstate[pidx[f.target]] = {
                    "fault": f, "active": False, "expired": False,
                    "resume_fires": None, "waits": 0}
        # fault-free plans take the deferred-verification fast path: the
        # engine records the wire (per-channel push/pop value order, one
        # list append per token) and `finalize` checks the sequence-tag
        # discipline in one batched pass — same math as the inline guards
        # at a fraction of the cost (bench_faults' <10% overhead budget)
        self.deferred = not self.plan.faults
        self.inline_wire = not self.deferred
        self.gates_fires = bool(self.pstate)
        if self.deferred:
            self.push_chan_log: List[List[int]] = [[] for _ in engine.chans]
            self.pop_chan_log: List[List[int]] = [[] for _ in engine.chans]

    def _ensure_writer_pos(self, engine: SelfTimedEngine) -> None:
        """Producer write positions per value: the observable "has the
        producer advanced past this token's send?" gap test at quiesce.
        O(total tokens), so built only when a quiesce actually happens."""
        if self._writer_pos_built:
            return
        self._writer_pos_built = True
        for pi in range(len(engine.procs)):
            for k, outs in enumerate(engine.outputs[pi]):
                for ci, v in outs:
                    self.chan[ci].writer_pos[v] = int(engine.pos[pi][k])

    # ----------------------------------------------------------- records --

    def _detect(self, target: str, violation: str, mechanism: str,
                detail: str) -> None:
        self.detections.append({"target": target, "violation": violation,
                                "mechanism": mechanism, "detail": detail})
        self._detected_targets.add(target)

    def _recover(self, target: str, action: str, attempts: int) -> None:
        self.recoveries.append({"target": target, "action": action,
                                "attempts": attempts})

    def _fail(self, target: str, violation: str, detail: str) -> None:
        self.unrecovered.append({"target": target, "violation": violation,
                                 "detail": detail})

    # ---------------------------------------------------------- injector --

    def _trigger(self, ci: int, seq: int) -> Optional[Fault]:
        for rec in self.chan[ci].faults:
            if not rec[1] and rec[0].at == seq:
                rec[1] = True
                self.injected.append(rec[0].as_dict())
                return rec[0]
        return None

    # ------------------------------------------------------------- hooks --

    def fire_allowed(self, engine: SelfTimedEngine, pi: int) -> bool:
        st = self.pstate.get(pi)
        if st is None or st["expired"]:
            return True
        f = st["fault"]
        if engine.pstats[pi].fires < f.at:
            return True
        if not st["active"]:
            st["active"] = True
            st["resume_fires"] = engine.fires + f.span
            self.injected.append(f.as_dict())
        if f.kind == STALL and engine.fires >= st["resume_fires"]:
            st["expired"] = True
            self._detect(f.target, "actor-stall", "progress-watchdog",
                         f"{st['waits'] or f.span} denial(s) observed, "
                         f"resumed after the wait elapsed")
            self._recover(f.target, "waited", 1)
            return True
        return False

    def on_push(self, engine: SelfTimedEngine, pi: int, ci: int, v: int):
        st = self.chan[ci]
        self.guard_events += 1
        seq = st.next_seq
        st.next_seq = seq + 1
        if st.pending_swap is not None:
            tag, st.pending_swap = st.pending_swap, None
        else:
            tag = seq
        payload = seq                   # true content == wire position
        ops = None                      # None -> plain single delivery
        f = self._trigger(ci, seq)
        if f is not None:
            if f.kind == DROP:
                ops = ()
            elif f.kind == DUPLICATE:
                # a second wire copy of the same tag arrives; the push-site
                # tag check sees the repeat immediately
                self._detect(st.name, "duplicate", "sequence-tag",
                             f"wire tag {tag} pushed twice")
                if self.recover:
                    self._recover(st.name, "suppress", 1)
                else:
                    ops = ((v, "deliver"), (v, "phantom"))
            elif f.kind == REORDER:
                st.pending_swap = tag   # next token takes this wire slot
                tag = tag + 1           # this one lands a slot late
            elif f.kind == CORRUPT:
                payload = seq + (f.arg if f.arg else 1)
            elif f.kind == CAPACITY:
                c = engine.chans[ci]
                c.capacity = f.arg if f.arg is not None else 0
        st.tag[v] = tag
        st.payload[v] = payload
        st.checksum[v] = seq            # guard side-band: per-token checksum
        st.snapshot.append(v)           # bounded replay log (maxlen evicts)
        return ops

    def on_pop(self, engine: SelfTimedEngine, pi: int, ci: int,
               v: int) -> None:
        st = self.chan[ci]
        self.guard_events += 1
        tag = st.tag.get(v)
        payload = st.payload.get(v, -1)
        if tag is None:                 # never pushed — engine can't serve
            st.delivered.append(payload)
            return
        if st.mode == "fifo":
            if tag != st.expect:
                self._detect(
                    st.name, "out-of-order", "sequence-tag",
                    f"pop saw wire tag {tag}, expected {st.expect}")
                self._hot_swap(engine, ci)
            else:
                st.expect = tag + 1
        elif st.mode == "register":
            if tag < st.expect:
                self._detect(
                    st.name, "out-of-order", "sequence-tag",
                    f"register regressed to wire tag {tag} after "
                    f"advancing to {st.expect}")
                self._hot_swap(engine, ci)
            else:
                st.expect = tag
        served = payload
        truth = st.checksum[v]
        if payload != truth:
            self._detect(st.name, "corrupt", "checksum",
                         f"token {v} payload {payload} fails its "
                         f"checksum ({truth})")
            if (self.recover and v in st.snapshot
                    and st.replays < self.plan.max_replays):
                st.replays += 1
                served = truth          # replayed from the snapshot log
                self._recover(st.name, "replay", st.replays)
            else:
                self._fail(st.name, "corrupt",
                           "snapshot window passed or replay budget "
                           "exhausted — corrupted payload served")
        st.delivered.append(served)

    def on_quiesce(self, engine: SelfTimedEngine,
                   reasons: Mapping[int, Tuple[str, int, int]]) -> str:
        if not self.watchdog.tick():
            self._fail("watchdog", "no-progress",
                       f"intervention budget ({self.watchdog.limit}) "
                       f"exhausted with work pending")
            return "deadlock"
        acted = False
        # stalled / crashed actors: virtual time passes while the network
        # is idle; a crash needs (and consumes) a restart grant
        for pi, st in self.pstate.items():
            if not st["active"] or st["expired"]:
                continue
            if engine.pc[pi] >= engine.n_inst[pi]:
                continue
            f = st["fault"]
            if f.kind == STALL:
                st["waits"] += 1
                if st["waits"] >= f.span:
                    st["expired"] = True
                    self._detect(f.target, "actor-stall",
                                 "progress-watchdog",
                                 f"{engine.pstats[pi].denials} denial(s) "
                                 f"observed; wait of {f.span} elapsed")
                    self._recover(f.target, "waited", st["waits"])
                acted = True
            elif not st.get("abandoned"):       # CRASH
                self._detect(f.target, "actor-crash", "progress-watchdog",
                             f"{engine.pstats[pi].denials} denial(s), no "
                             f"progress while work pending")
                if self.recover and self.watchdog.restart():
                    st["expired"] = True
                    self._recover(f.target, "restart",
                                  self.watchdog.restarts)
                    acted = True
                else:
                    st["abandoned"] = True
                    self._fail(f.target, "actor-crash",
                               "restart budget exhausted — culprit actor "
                               "named, run abandoned")
        # starved consumers: a token whose producer already advanced past
        # its send was lost in flight — replay it from the snapshot log
        self._ensure_writer_pos(engine)
        for pi, (kind, ci, v) in sorted(reasons.items()):
            if kind != "empty":
                continue
            st = self.chan[ci]
            c = engine.chans[ci]
            wp = st.writer_pos.get(v)
            if wp is None or engine.pc[c.producer] <= wp:
                continue                # producer genuinely hasn't sent it
            if c.pushed_step[v] >= 0:
                continue                # visible already; not a gap
            if (ci, v) in self._failed_tokens:
                continue                # already reported unrecoverable
            self._detect(st.name, "gap", "progress-watchdog",
                         f"token {v} lost in flight (producer advanced "
                         f"past its send, consumer starving)")
            if (self.recover and v in st.snapshot
                    and st.replays < self.plan.max_replays):
                st.replays += 1
                engine.redeliver(ci, v)
                self._recover(st.name, "replay", st.replays)
                acted = True
            else:
                self._failed_tokens.add((ci, v))
                self._fail(st.name, "gap",
                           "snapshot window passed or replay budget "
                           "exhausted — token unrecoverable")
        # capacity exhaustion: spill the blocking full channel(s) to
        # unbounded, with planned-vs-effective accounting
        for pi, (kind, ci, v) in sorted(reasons.items()):
            if kind != "full":
                continue
            c = engine.chans[ci]
            if c.capacity is None:
                continue
            planned = self._capacity_planned[ci]
            self._detect(c.name, "capacity-exhausted", "progress-watchdog",
                         f"occupancy {c.occ} blocked at capacity "
                         f"{c.capacity} (planned {planned})")
            self.spills.append({"channel": c.name, "capacity": c.capacity,
                                "planned": planned, "occupancy": int(c.occ),
                                "fault_induced": c.capacity != planned})
            c.capacity = None
            acted = True
        return "continue" if acted else "deadlock"

    # -------------------------------------------------------- degradation --

    def _hot_swap(self, engine: SelfTimedEngine, ci: int) -> None:
        st = self.chan[ci]
        if st.mode == "reorder":
            return
        to = DEGRADED_LOWERING.get(st.lowering, REORDER_BUFFER)
        self.swaps.append({"channel": st.name, "from": st.lowering,
                           "to": to,
                           "stream_slots": self._capacity_planned[ci],
                           "addressable_slots": None})   # filled at finalize
        st.mode = "reorder"
        if self.recover:
            self._recover(st.name, "hot-swap", 1)

    # ----------------------------------------------------------- finalize --

    def _verify_deferred(self) -> None:
        """Batched verification of the recorded wire — the deferred
        counterpart of the inline pop-site checks.  A FIFO's pops must
        replay its pushes verbatim (tag ``i`` arriving at pop ``i``); a
        register's tags must never regress.  The common case is one
        C-speed list comparison per channel; the Python work happens only
        on an actual violation."""
        self.guard_events = (sum(map(len, self.push_chan_log))
                             + sum(map(len, self.pop_chan_log)))
        for ci, st in enumerate(self.chan):
            pushes = self.push_chan_log[ci]
            pops = self.pop_chan_log[ci]
            if st.mode == "fifo":
                if pops != pushes[:len(pops)]:
                    bad = next(i for i, (a, b) in enumerate(zip(pops, pushes))
                               if a != b)
                    self._detect(
                        st.name, "out-of-order", "sequence-tag",
                        f"pop saw wire tag {pushes.index(pops[bad])}, "
                        f"expected {bad}")
                    self._hot_swap(self.engine, ci)
            elif st.mode == "register":
                tag = {v: i for i, v in enumerate(pushes)}
                tags = list(map(tag.__getitem__, pops))
                if tags != sorted(tags):
                    bad = next(i for i in range(1, len(tags))
                               if tags[i] < tags[i - 1])
                    self._detect(
                        st.name, "out-of-order", "sequence-tag",
                        f"register regressed to wire tag {tags[bad]} after "
                        f"advancing to {tags[bad - 1]}")
                    self._hot_swap(self.engine, ci)

    def finalize(self, engine: SelfTimedEngine,
                 run: SelfTimedReport) -> ResilienceReport:
        if self.deferred:
            self._verify_deferred()
        # capacity audit: configured capacity must match the plan — catches
        # a capacity fault that never blocked anything
        for ci, c in enumerate(engine.chans):
            planned = self._capacity_planned[ci]
            if c.capacity != planned and c.name not in \
                    {s["channel"] for s in self.spills}:
                self._detect(c.name, "capacity-loss", "capacity-audit",
                             f"configured capacity {c.capacity} != "
                             f"planned {planned}")
        for sw in self.swaps:
            for c in engine.chans:
                if c.name == sw["channel"]:
                    sw["addressable_slots"] = int(c.high)
        # a reorder on an addressable buffer violates nothing — wire order
        # is not part of that channel's contract — so silence there is
        # correctness, not a missed detection
        benign = {(REORDER, st.name) for st in self.chan
                  if st.mode == "reorder"}
        undetected = [f for f in self.injected
                      if f["target"] not in self._detected_targets
                      and (f["kind"], f["target"]) not in benign]
        report = ResilienceReport(
            kernel=engine.ppn.kernel_name, policy=engine.policy,
            plan=self.plan.as_dict(),
            injected=self.injected, detections=self.detections,
            recoveries=self.recoveries, swaps=self.swaps,
            spills=self.spills, unrecovered=self.unrecovered,
            undetected=undetected, watchdog=self.watchdog.as_dict(),
            completed=run.completed, guard_events=self.guard_events)
        return report

    def delivered_streams(self) -> Dict[str, List[int]]:
        if self.deferred:
            # payload == checksum == wire tag when nothing was injected;
            # reconstructed on demand so a plain overhead run never pays
            out: Dict[str, List[int]] = {}
            for ci, st in enumerate(self.chan):
                tag = {v: i for i, v in enumerate(self.push_chan_log[ci])}
                out[st.name] = [tag.get(v, -1)
                                for v in self.pop_chan_log[ci]]
            return out
        return {st.name: list(st.delivered) for st in self.chan}


class GuardedRun:
    """Everything one guarded execution produced.  ``delivered`` (the
    per-channel payload streams in pop order) is materialized lazily —
    only oracle comparisons need it."""

    def __init__(self, run: SelfTimedReport, resilience: ResilienceReport,
                 hooks: ResilienceHooks):
        self.run = run
        self.resilience = resilience
        self._hooks = hooks
        self._delivered: Optional[Dict[str, List[int]]] = None

    @property
    def delivered(self) -> Dict[str, List[int]]:
        if self._delivered is None:
            self._delivered = self._hooks.delivered_streams()
        return self._delivered

    @property
    def status(self) -> str:
        return self.resilience.status


def run_guarded(ppn, capacities: Optional[Mapping[str, Optional[int]]] = None,
                plan: Optional[FaultPlan] = None,
                lowerings: Optional[Mapping[str, str]] = None,
                policy: str = "sequential",
                recover: bool = True,
                oracle: Optional[GuardedRun] = None,
                record_timeline: bool = False) -> GuardedRun:
    """Execute ``ppn`` with the guards armed and ``plan``'s faults injected.

    ``lowerings`` (channel name → lowering) selects each channel's guard
    discipline — pass the analysis plan's lowerings; unknown channels are
    guarded addressably.  When ``oracle`` (a fault-free `GuardedRun`) is
    given, the delivered-payload streams are compared and
    ``resilience.outputs_match`` is set — the no-silent-corruption check.
    Never hangs: structural deadlock is detected by the engine, recovery
    loops are bounded by the plan's watchdog budget."""
    hooks = ResilienceHooks(plan=plan, lowerings=lowerings, recover=recover)
    engine = SelfTimedEngine(ppn, capacities, policy=policy,
                             record_timeline=record_timeline, hooks=hooks)
    run = engine.run()
    resilience = hooks.finalize(engine, run)
    gr = GuardedRun(run=run, resilience=resilience, hooks=hooks)
    if oracle is not None:
        resilience.outputs_match = (run.completed
                                    and gr.delivered == oracle.delivered)
    return gr
