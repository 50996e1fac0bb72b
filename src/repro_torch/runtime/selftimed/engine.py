"""Self-timed (dataflow-driven) PPN execution engine.

The trace simulator (`runtime/simulator.py`) replays channels against the
*sequential linearization* — a fixed global order that exists only for
acyclic networks.  This engine executes the network the way the paper's
recovered FIFOs actually synchronize: **by data availability alone**.

Firing rule
-----------
Every process executes its instances in local-schedule order (a process is a
sequential program).  The next instance *fires* when

* every input token it reads is present in its channel, and
* every channel it writes has a free slot — where the slots this fire's own
  pops retire count as free (reads drain before writes, matching the sizing
  sweeps' event semantics).

A fire pops its input tokens (a token retires — freeing its slot — when its
last reader consumed it; broadcast/multiplicity reads are per-edge), then
pushes one token per output channel.  Channels are bounded queues: a full
channel back-pressures its producer, an empty channel blocks its consumer.
There is no global clock and no ordering between processes beyond the
tokens themselves.

Scheduling policies
-------------------
``"sequential"`` — one fire per step, picking the fireable instance with the
lowest *joint global rank* (the same ranks the sizing model linearizes by).
When nothing ever blocks, this replays the sequential linearization exactly,
so per-channel occupancy high-water marks equal the trace simulator's peaks
— the cross-check `Analysis.validate(mode="selftimed")` performs.  Blocked
processes park on the exact token / slot they need and wake event-driven.

``"concurrent"`` — synchronous rounds: every process whose next instance is
fireable against the round-start state fires in the same step (tokens pushed
in a round become visible the next round).  This is the policy that gives
meaningful throughput (fires/step), per-step stall attribution and
timelines; benchmarks and the stall-bound-slowdown negative checks use it.

Deadlock
--------
When no process can fire and instances are pending the engine *stops* —
bounded time, never a hang — and reports structurally: each blocked process
waits on the producer of its empty input (or the consumer of its full
output); following those edges from any blocked process must reach a cycle
(a finished process can neither owe a token nor hold a slot in a well-formed
net).  The cycle, per-channel stall attribution, and the culprit channel
(the smallest-capacity full channel on the cycle) land in `DeadlockInfo`.
Deadlock with bounded buffers is schedule-independent for (monotone) process
networks, so whichever policy observed it, it is a property of the
capacities, not of the schedule.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from ...core.patterns import _lex_rank
from ...core.ppn import PPN
from .observe import ChannelStats, DeadlockInfo, ProcessStats, SelfTimedReport

#: effective capacity of an unbounded channel
_UNBOUNDED = 1 << 62

#: timelines above this many steps are truncated (rendering only)
_TIMELINE_CAP = 400


class SelfTimedError(RuntimeError):
    """The self-timed execution could not proceed as requested."""


class EngineHooks:
    """Instrumentation/intervention seam for fault injection and runtime
    guards (`runtime/resilience/`).  Every method is a no-op by default, and
    the engine only consults a hooks object when one was passed — the plain
    execution path pays a single ``is None`` test per fire.

    Contract (all indices are engine-internal: ``pi`` a process index,
    ``ci`` a channel index, ``v`` a value index on that channel):

    * ``bind(engine)`` — called once, after the engine built its channel and
      adjacency state, before any fire.
    * ``fire_allowed(engine, pi)`` — gate an otherwise fireable instance; a
      ``False`` makes the actor refuse work this scheduling opportunity
      (the engine counts the denial in ``ProcessStats.denials`` and re-polls
      after subsequent fires and at quiesce).  Must be a pure predicate —
      it may be called more than once per opportunity.
    * ``on_push(engine, pi, ci, v)`` — intercept one token emission; returns
      the deliveries to apply: an iterable of ``(value, op)`` with op
      ``"deliver"`` (normal visible token) or ``"phantom"`` (occupies a slot
      but is never visible nor retired — a duplicated token's wire copy).
      Returning ``()`` drops the token: the consumer will starve on it
      unless a later intervention redelivers it.
    * ``on_pop(engine, pi, ci, v)`` — observe one token consumption (guards
      check sequence tags here).  Must not mutate engine state.
    * ``on_quiesce(engine, reasons)`` — the engine found no fireable
      instance with work pending.  ``reasons`` maps blocked process index →
      ``(kind, ci, v)`` exactly as `DeadlockInfo` reports them (processes
      parked by ``fire_allowed`` are NOT in it — the hooks object knows
      its own).  Return ``"continue"`` after mutating state (redelivering a
      token via `SelfTimedEngine.redeliver`, lifting a capacity, releasing
      a stalled actor) to resume execution, or ``"deadlock"`` to let the
      engine build its structural report.  A hooks object returning
      ``"continue"`` without eventually enabling progress must bound its
      own interventions (the resilience watchdog does) — the engine trusts
      it and would otherwise loop.

    Two class attributes let a hooks object opt out of the per-token /
    per-opportunity calls (read once, after ``bind``):

    * ``gates_fires`` — False means ``fire_allowed`` is never consulted
      (the hooks object knows it gates nothing this run);
    * ``inline_wire`` — False means ``on_push``/``on_pop`` are never
      called; instead the engine appends each token's value index to the
      hooks' ``push_chan_log[ci]`` / ``pop_chan_log[ci]`` lists (which
      ``bind`` must create, one per channel).  This is the deferred-
      verification mode the resilience guards use on fault-free plans:
      the wire is recorded at C speed and the sequence-tag discipline is
      checked in one batched pass at finalize instead of per token.
    """

    #: consult ``fire_allowed`` for every scheduling opportunity
    gates_fires = True
    #: call ``on_push``/``on_pop`` per token (False: record to the hooks'
    #: per-channel ``push_chan_log``/``pop_chan_log`` lists instead)
    inline_wire = True

    def bind(self, engine: "SelfTimedEngine") -> None:
        pass

    def fire_allowed(self, engine: "SelfTimedEngine", pi: int) -> bool:
        return True

    def on_push(self, engine: "SelfTimedEngine", pi: int, ci: int, v: int):
        return ((v, "deliver"),)

    def on_pop(self, engine: "SelfTimedEngine", pi: int, ci: int,
               v: int) -> None:
        pass

    def on_quiesce(self, engine: "SelfTimedEngine",
                   reasons: Mapping[int, Tuple[str, int, int]]) -> str:
        return "deadlock"


class DeadlockError(SelfTimedError):
    """Structural deadlock: no fireable process, instances pending.
    Carries the full `SelfTimedReport` (``.report``) whose ``.deadlock``
    names the blocking cycle and culprit channel."""

    def __init__(self, report: SelfTimedReport):
        self.report = report
        d = report.deadlock
        super().__init__(d.summary() if d is not None else "deadlock")


class _Chan:
    """One bounded channel's runtime state."""

    __slots__ = ("name", "capacity", "producer", "consumer", "reads_left",
                 "pushed_step", "occ", "high", "pushes", "stall_empty",
                 "stall_full", "num_values")

    def __init__(self, name: str, capacity: Optional[int], producer: int,
                 consumer: int, reads_left: np.ndarray):
        self.name = name
        self.capacity = capacity
        self.producer = producer
        self.consumer = consumer
        self.reads_left = reads_left
        self.pushed_step = np.full(len(reads_left), -1, dtype=np.int64)
        self.num_values = len(reads_left)
        self.occ = 0
        self.high = 0
        self.pushes = 0
        self.stall_empty = 0
        self.stall_full = 0

    @property
    def cap(self) -> int:
        return _UNBOUNDED if self.capacity is None else self.capacity


def process_cycles(ppn: PPN) -> List[List[str]]:
    """Strongly connected components of the process graph that contain a
    cycle (more than one process, or a self-loop channel), in deterministic
    order.  Non-empty iff the PPN is cyclic."""
    names = list(ppn.processes)
    index = {n: i for i, n in enumerate(names)}
    adj: List[Set[int]] = [set() for _ in names]
    radj: List[Set[int]] = [set() for _ in names]
    selfloop = [False] * len(names)
    for ch in ppn.channels:
        if ch.num_edges == 0:
            continue
        a, b = index[ch.producer], index[ch.consumer]
        if a == b:
            selfloop[a] = True
        adj[a].add(b)
        radj[b].add(a)
    # Kosaraju, iterative
    seen = [False] * len(names)
    order: List[int] = []
    for s in range(len(names)):
        if seen[s]:
            continue
        seen[s] = True
        stack = [(s, iter(sorted(adj[s])))]
        while stack:
            node, it = stack[-1]
            for nxt in it:
                if not seen[nxt]:
                    seen[nxt] = True
                    stack.append((nxt, iter(sorted(adj[nxt]))))
                    break
            else:
                order.append(node)
                stack.pop()
    seen = [False] * len(names)
    sccs: List[List[str]] = []
    for s in reversed(order):
        if seen[s]:
            continue
        comp = []
        stack2 = [s]
        seen[s] = True
        while stack2:
            n = stack2.pop()
            comp.append(n)
            for m in radj[n]:
                if not seen[m]:
                    seen[m] = True
                    stack2.append(m)
        if len(comp) > 1 or selfloop[comp[0]]:
            sccs.append(sorted(names[i] for i in comp))
    return sccs


def cycle_channels(ppn: PPN) -> List[str]:
    """Names of channels lying on a process-graph cycle (both endpoints in
    the same cyclic SCC) — the channels whose capacities can deadlock."""
    out = []
    for scc in process_cycles(ppn):
        members = set(scc)
        for ch in ppn.channels:
            if (ch.num_edges and ch.producer in members
                    and ch.consumer in members):
                out.append(ch.name)
    return out


class SelfTimedEngine:
    """One execution of ``ppn`` under per-channel ``capacities``.

    ``capacities`` maps channel name → slot count; channels absent from the
    mapping (or mapped to ``None``) are unbounded — an "ample" run whose
    high-water marks are the network's true peak demands."""

    def __init__(self, ppn: PPN,
                 capacities: Optional[Mapping[str, Optional[int]]] = None,
                 policy: str = "sequential",
                 record_timeline: bool = False,
                 hooks: Optional[EngineHooks] = None):
        if policy not in ("sequential", "concurrent"):
            raise ValueError(f"unknown policy {policy!r} "
                             f"(sequential | concurrent)")
        caps = dict(capacities or {})
        self.ppn = ppn
        self.policy = policy
        self.procs = list(ppn.processes.values())
        pidx = {p.name: i for i, p in enumerate(self.procs)}
        params = ppn.params

        # execution order (local schedule) and joint priority ranks
        self.order: List[np.ndarray] = []
        self.pos: List[np.ndarray] = []
        self.n_inst: List[int] = []
        mats = []
        for p in self.procs:
            n = len(p.pts)
            self.n_inst.append(n)
            if n == 0:
                self.order.append(np.zeros(0, dtype=np.intp))
                self.pos.append(np.zeros(0, dtype=np.intp))
                mats.append(np.zeros((0, 1), dtype=np.int64))
                continue
            lr = p.local_rank(params)
            order = np.argsort(lr, kind="stable")
            pos = np.empty(n, dtype=np.intp)
            pos[order] = np.arange(n, dtype=np.intp)
            self.order.append(order)
            self.pos.append(pos)
            mats.append(np.asarray(p.global_ts(p.pts, params),
                                   dtype=np.int64))
        width = max((m.shape[1] for m in mats), default=1)
        padded = [m if m.shape[1] == width else np.concatenate(
            [m, np.full((m.shape[0], width - m.shape[1]), -_UNBOUNDED,
                        dtype=np.int64)], axis=1) for m in mats]
        stacked = np.concatenate(padded, axis=0) if padded else \
            np.zeros((0, 1), dtype=np.int64)
        joint = _lex_rank(stacked) if len(stacked) else \
            np.zeros(0, dtype=np.int64)
        self.jrank: List[np.ndarray] = []
        off = 0
        for n in self.n_inst:
            self.jrank.append(joint[off:off + n])
            off += n

        # channel states + per-instance adjacency (channel idx, value idx)
        self.chans: List[_Chan] = []
        self.inputs: List[List[List[Tuple[int, int]]]] = [
            [[] for _ in range(n)] for n in self.n_inst]
        self.outputs: List[List[List[Tuple[int, int]]]] = [
            [[] for _ in range(n)] for n in self.n_inst]
        for ch in ppn.channels:
            if ch.num_edges == 0:
                continue
            pi, cj = pidx[ch.producer], pidx[ch.consumer]
            w_rows = self.procs[pi].domain_index().rows_of(ch.src_pts)
            r_rows = self.procs[cj].domain_index().rows_of(ch.dst_pts)
            uniq, vinv = np.unique(w_rows, return_inverse=True)
            ci = len(self.chans)
            self.chans.append(_Chan(
                ch.name, caps.get(ch.name), pi, cj,
                np.bincount(vinv, minlength=len(uniq)).astype(np.int64)))
            # adjacency is keyed by domain ROW (what `order[pi][pc]` yields)
            for v, k in enumerate(uniq):
                self.outputs[pi][int(k)].append((ci, v))
            ins_cj = self.inputs[cj]
            for e in range(len(r_rows)):
                ins_cj[int(r_rows[e])].append((ci, int(vinv[e])))

        self.pc = [0] * len(self.procs)
        self.steps = 0
        self.fires = 0
        self.total = sum(self.n_inst)
        self.pstats = [ProcessStats(p.name, n)
                       for p, n in zip(self.procs, self.n_inst)]
        self.stalled_procs: Set[int] = set()
        #: processes that fired below the running max joint rank under the
        #: sequential policy — i.e. the linearization could not serialize
        #: them and blocking reordered their fires (late-edge fallout).
        #: Channels adjacent to these are the ONLY ones whose high-water
        #: may differ from the trace simulator's exact peak.
        self.out_of_order: Set[int] = set()
        self.timeline: Optional[List[List[str]]] = (
            [[] for _ in self.procs] if record_timeline else None)
        self._sccs = process_cycles(ppn)
        self._deadlock: Optional[DeadlockInfo] = None
        self.hooks = hooks
        if hooks is not None:
            hooks.bind(self)
        # flags are read once, after bind (hooks decide per run): skipping
        # the per-token / per-opportunity calls is what makes the guards'
        # deferred-verification mode nearly free
        self._gate = (hooks if hooks is not None and hooks.gates_fires
                      else None)
        if hooks is not None and not hooks.inline_wire:
            self._push_rec = [lst.append for lst in hooks.push_chan_log]
            self._pop_rec = [lst.append for lst in hooks.pop_chan_log]
        else:
            self._push_rec = self._pop_rec = None

    # ------------------------------------------------------------ firing --

    def _check(self, pi: int, snapshot_step: Optional[int] = None
               ) -> Optional[Tuple[str, int, int]]:
        """Can ``pi``'s next instance fire?  None, or the blocking reason
        ``(kind, channel_idx, value_idx)``.  Under snapshot semantics tokens
        pushed at or after ``snapshot_step`` are not yet visible."""
        k = self.order[pi][self.pc[pi]]
        ins = self.inputs[pi][k]
        for ci, v in ins:
            ps = self.chans[ci].pushed_step[v]
            if ps < 0 or (snapshot_step is not None and ps >= snapshot_step):
                return ("empty", ci, v)
        outs = self.outputs[pi][k]
        if outs:
            freed: Dict[int, int] = {}
            if ins:
                cnt: Dict[Tuple[int, int], int] = {}
                for cv in ins:
                    cnt[cv] = cnt.get(cv, 0) + 1
                for (ci, v), m in cnt.items():
                    if self.chans[ci].reads_left[v] == m:
                        freed[ci] = freed.get(ci, 0) + 1
            for ci, v in outs:
                c = self.chans[ci]
                if c.occ - freed.get(ci, 0) >= c.cap:
                    return ("full", ci, v)
        return None

    def _apply_pops(self, pi: int) -> List[int]:
        """Consume the next instance's input tokens; returns the channels
        whose occupancy dropped (a token retired)."""
        k = self.order[pi][self.pc[pi]]
        freed: List[int] = []
        hooks = self.hooks
        rec = self._pop_rec
        for ci, v in self.inputs[pi][k]:
            if rec is not None:
                rec[ci](v)
            elif hooks is not None:
                hooks.on_pop(self, pi, ci, v)
            c = self.chans[ci]
            c.reads_left[v] -= 1
            if c.reads_left[v] == 0:
                c.occ -= 1
                freed.append(ci)
        return freed

    def redeliver(self, ci: int, v: int) -> None:
        """Make value ``v`` of channel ``ci`` visible now — the recovery
        primitive hooks use to replay a token lost in flight.  Counts as a
        push (occupancy, high-water) at the current step."""
        c = self.chans[ci]
        c.occ += 1
        c.pushes += 1
        if c.occ > c.high:
            c.high = c.occ
        c.pushed_step[v] = self.steps

    def _apply_pushes(self, pi: int, step: int) -> List[Tuple[int, int]]:
        """Emit the next instance's output tokens and advance the pc."""
        k = self.order[pi][self.pc[pi]]
        pushed: List[Tuple[int, int]] = []
        hooks = self.hooks
        rec = self._push_rec
        for ci, v in self.outputs[pi][k]:
            c = self.chans[ci]
            if hooks is None:
                ops = None
            elif rec is not None:
                rec[ci](v)
                ops = None
            else:
                ops = hooks.on_push(self, pi, ci, v)
            if ops is None:
                c.occ += 1
                c.pushes += 1
                if c.occ > c.high:
                    c.high = c.occ
                c.pushed_step[v] = step
                pushed.append((ci, v))
                continue
            for val, op in ops:
                c.occ += 1
                if c.occ > c.high:
                    c.high = c.occ
                if op == "phantom":
                    continue       # occupies a slot, never becomes visible
                c.pushes += 1
                c.pushed_step[val] = step
                pushed.append((ci, val))
        self.pc[pi] += 1
        ps = self.pstats[pi]
        ps.fires += 1
        if ps.first_fire < 0:
            ps.first_fire = step
        ps.last_fire = step
        return pushed

    def _note_stall(self, pi: int, reason: Tuple[str, int, int]) -> None:
        kind, ci, _ = reason
        c = self.chans[ci]
        ps = self.pstats[pi]
        if kind == "empty":
            c.stall_empty += 1
            ps.stall_in += 1
        else:
            c.stall_full += 1
            ps.stall_out += 1
        ps.stall_channels[c.name] = ps.stall_channels.get(c.name, 0) + 1
        self.stalled_procs.add(pi)

    # ------------------------------------------------------------- loops --

    def _run_sequential(self) -> None:
        heap: List[Tuple[int, int]] = []
        parked: Dict[int, Tuple[str, int, int]] = {}
        value_waiters: Dict[Tuple[int, int], List[int]] = {}
        space_waiters: Dict[int, List[int]] = {}
        fault_parked: Set[int] = set()   # fire_allowed denials (hooks only)
        hooks = self.hooks
        gate = self._gate

        def schedule(pi: int) -> None:
            if self.pc[pi] >= self.n_inst[pi]:
                return
            if gate is not None and not gate.fire_allowed(self, pi):
                self.pstats[pi].denials += 1
                fault_parked.add(pi)
                return
            r = self._check(pi)
            if r is None:
                k = self.order[pi][self.pc[pi]]
                heapq.heappush(heap, (int(self.jrank[pi][k]), pi))
            else:
                parked[pi] = r
                self._note_stall(pi, r)
                kind, ci, v = r
                if kind == "empty":
                    value_waiters.setdefault((ci, v), []).append(pi)
                else:
                    space_waiters.setdefault(ci, []).append(pi)

        for pi in range(len(self.procs)):
            schedule(pi)
        jmax = -_UNBOUNDED
        while True:
            while heap:
                jr, pi = heapq.heappop(heap)
                r = self._check(pi)
                if r is not None:      # invalidated since it was queued
                    parked[pi] = r
                    self._note_stall(pi, r)
                    kind, ci, v = r
                    if kind == "empty":
                        value_waiters.setdefault((ci, v), []).append(pi)
                    else:
                        space_waiters.setdefault(ci, []).append(pi)
                    continue
                if gate is not None and not gate.fire_allowed(self, pi):
                    self.pstats[pi].denials += 1
                    fault_parked.add(pi)
                    continue
                if jr < jmax:
                    self.out_of_order.add(pi)
                else:
                    jmax = jr
                freed = self._apply_pops(pi)
                pushed = self._apply_pushes(pi, self.steps)
                self.fires += 1
                self.steps += 1
                woken: Set[int] = set()
                for cv in pushed:
                    woken.update(value_waiters.pop(cv, ()))
                for ci in set(freed):
                    woken.update(space_waiters.pop(ci, ()))
                for q in woken:
                    parked.pop(q, None)
                    schedule(q)
                schedule(pi)
                if fault_parked:       # a fire may have released a stall
                    for q in sorted(fault_parked):
                        if gate.fire_allowed(self, q):
                            fault_parked.discard(q)
                            schedule(q)
            if self.fires >= self.total:
                return
            # quiesce: nothing fireable, instances pending.  Hooks may
            # intervene (redeliver a token, lift a capacity, release an
            # actor) and ask the engine to carry on; the ready state is
            # rebuilt from scratch since any channel may have changed.
            if hooks is None or hooks.on_quiesce(self, dict(parked)) \
                    != "continue":
                self._deadlock = self._build_deadlock(parked)
                return
            parked.clear()
            value_waiters.clear()
            space_waiters.clear()
            fault_parked.clear()
            for pi in range(len(self.procs)):
                schedule(pi)

    def _run_concurrent(self) -> None:
        nproc = len(self.procs)
        hooks = self.hooks
        gate = self._gate
        while self.fires < self.total:
            fireable: List[int] = []
            blocked: Dict[int, Tuple[str, int, int]] = {}
            denied: Set[int] = set()
            for pi in range(nproc):
                if self.pc[pi] >= self.n_inst[pi]:
                    continue
                r = self._check(pi, snapshot_step=self.steps)
                if r is not None:
                    blocked[pi] = r
                elif gate is not None and not gate.fire_allowed(self, pi):
                    self.pstats[pi].denials += 1
                    denied.add(pi)
                else:
                    fireable.append(pi)
            if not fireable:
                # quiesce: hooks may intervene and burn an idle round
                # (virtual time passes — a stalled actor's wait elapses).
                if hooks is not None and \
                        hooks.on_quiesce(self, dict(blocked)) == "continue":
                    self.steps += 1
                    continue
                self._deadlock = self._build_deadlock(blocked)
                return
            for pi, reason in blocked.items():
                self._note_stall(pi, reason)
            for pi in fireable:        # reads drain before writes
                self._apply_pops(pi)
            for pi in fireable:
                self._apply_pushes(pi, self.steps)
                self.fires += 1
            if self.timeline is not None and self.steps < _TIMELINE_CAP:
                for pi in range(nproc):
                    mark = ("F" if pi in fireable else
                            "." if self.pc[pi] >= self.n_inst[pi] else
                            "x" if pi in denied else
                            "i" if blocked[pi][0] == "empty" else "o")
                    self.timeline[pi].append(mark)
            self.steps += 1

    # ----------------------------------------------------------- reports --

    def _build_deadlock(self, reasons: Mapping[int, Tuple[str, int, int]]
                        ) -> DeadlockInfo:
        def entry(pi: int) -> Dict[str, object]:
            kind, ci, _ = reasons[pi]
            c = self.chans[ci]
            return {"process": self.procs[pi].name, "kind": kind,
                    "channel": c.name, "occupancy": int(c.occ),
                    "capacity": c.capacity}

        blocked = [entry(pi) for pi in sorted(reasons)]
        # wait-for edges: empty input -> its producer, full output -> its
        # consumer; a finished process cannot be waited on in a well-formed
        # net (it pushed every token and freed every slot), so following the
        # edges from any blocked process reaches a cycle.
        wait: Dict[int, Optional[int]] = {}
        for pi, (kind, ci, _) in reasons.items():
            c = self.chans[ci]
            q = c.producer if kind == "empty" else c.consumer
            wait[pi] = q if self.pc[q] < self.n_inst[q] else None
        cycle: List[Dict[str, object]] = []
        for start in sorted(reasons):
            seen: Dict[int, int] = {}
            path: List[int] = []
            cur: Optional[int] = start
            while cur is not None and cur in reasons and cur not in seen:
                seen[cur] = len(path)
                path.append(cur)
                cur = wait[cur]
            if cur is not None and cur in seen:
                cycle = [entry(pi) for pi in path[seen[cur]:]]
                break
        full = [e for e in cycle if e["kind"] == "full"
                and e["capacity"] is not None]
        if full:
            culprit = min(full, key=lambda e: e["capacity"])["channel"]
        elif cycle:
            culprit = cycle[0]["channel"]
        elif blocked:                  # starvation chain (malformed net)
            culprit = blocked[0]["channel"]
        else:
            culprit = None
        return DeadlockInfo(self.steps, self.fires,
                            self.total - self.fires, blocked, cycle, culprit)

    def _critical_cycle(self) -> Optional[Dict[str, object]]:
        """The cyclic SCC whose internal channels absorbed the most stalls
        (ties: first in SCC order) — the cycle bounding throughput."""
        best: Optional[Dict[str, object]] = None
        for scc in self._sccs:
            members = set(scc)
            rows = [{"name": c.name, "capacity": c.capacity,
                     "high_water": c.high,
                     "stalls": c.stall_empty + c.stall_full}
                    for c in self.chans
                    if (self.procs[c.producer].name in members
                        and self.procs[c.consumer].name in members)]
            total = sum(r["stalls"] for r in rows)
            if best is None or total > best["stalls"]:
                best = {"processes": scc, "channels": rows, "stalls": total}
        return best

    def run(self) -> SelfTimedReport:
        if self.policy == "sequential":
            self._run_sequential()
        else:
            self._run_concurrent()
        timeline = None
        if self.timeline is not None:
            timeline = {p.name: "".join(line)
                        for p, line in zip(self.procs, self.timeline)}
        report = SelfTimedReport(
            kernel=self.ppn.kernel_name, policy=self.policy,
            steps=self.steps, fires=self.fires,
            total_instances=self.total,
            completed=self.fires == self.total,
            cyclic=bool(self._sccs),
            channels=[ChannelStats(c.name, c.capacity, c.num_values,
                                   c.pushes, c.high, c.stall_empty,
                                   c.stall_full) for c in self.chans],
            processes=list(self.pstats),
            deadlock=self._deadlock,
            critical_cycle=self._critical_cycle(),
            timeline=timeline,
            out_of_order=sorted(self.procs[pi].name
                                for pi in self.out_of_order))
        return report


def execute_ppn(ppn: PPN,
                capacities: Optional[Mapping[str, Optional[int]]] = None,
                policy: str = "sequential",
                record_timeline: bool = False,
                on_deadlock: str = "raise",
                hooks: Optional[EngineHooks] = None) -> SelfTimedReport:
    """Execute ``ppn`` self-timed under ``capacities`` (name → slots; absent
    or ``None`` = unbounded) and return the `SelfTimedReport`.

    ``on_deadlock="raise"`` raises `DeadlockError` (carrying the report);
    ``"report"`` returns the report with ``completed=False`` and
    ``.deadlock`` filled in.  Either way detection is structural and runs in
    bounded time — the engine never busy-waits or hangs.  ``hooks`` installs
    an `EngineHooks` seam (fault injection / runtime guards); the plain path
    is untouched when it is None."""
    if on_deadlock not in ("raise", "report"):
        raise ValueError(f"on_deadlock={on_deadlock!r} (raise | report)")
    report = SelfTimedEngine(ppn, capacities, policy=policy,
                             record_timeline=record_timeline,
                             hooks=hooks).run()
    if not report.completed and on_deadlock == "raise":
        raise DeadlockError(report)
    return report
