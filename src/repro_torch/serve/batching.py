"""Continuous batching for the decode loop.

Fixed-capacity slot model (the decode step has a static batch): a
`BatchSlots` tracks per-slot occupancy / positions / completion, admits new
requests into free slots (prefilling only the new slot's cache region), and
retires finished sequences each step — the vLLM-style scheduler specialized
to a decode step of static shapes.

The KV cache is slot-major (batch dim == slot), so admission writes one
slot's cache rows and eviction is O(1) bookkeeping.  Everything here is
host-side control logic (unit-tested without a model); `serve_loop` glues it
to Model.prefill/decode.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclass
class BatchSlots:
    """Occupancy bookkeeping for a static decode batch."""
    capacity: int
    max_seq: int
    request: List[Optional[Request]] = None
    pos: np.ndarray = None              # next position per slot

    def __post_init__(self):
        if self.request is None:
            self.request = [None] * self.capacity
        if self.pos is None:
            self.pos = np.zeros(self.capacity, np.int32)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.request) if r is None]

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.request) if r is not None]

    def admit(self, slot: int, req: Request) -> None:
        assert self.request[slot] is None
        assert len(req.prompt) < self.max_seq
        self.request[slot] = req
        self.pos[slot] = len(req.prompt)

    def retire_finished(self) -> List[Request]:
        out = []
        for i, r in enumerate(self.request):
            if r is not None and (r.done or self.pos[i] >= self.max_seq):
                out.append(r)
                self.request[i] = None
                self.pos[i] = 0
        return out

    @property
    def utilization(self) -> float:
        return len(self.active_slots()) / self.capacity


class ContinuousBatcher:
    """Admission queue + slot scheduler around a decode step.

    step_fn(slot_tokens (B,1), slot_pos (B,)) -> next_tokens (B,)
    prefill_fn(slot, prompt) -> first_token        (fills that slot's cache)
    """

    def __init__(self, slots: BatchSlots, prefill_fn: Callable,
                 step_fn: Callable):
        self.slots = slots
        self.prefill_fn = prefill_fn
        self.step_fn = step_fn
        self.queue: Deque[Request] = deque()
        self.completed: List[Request] = []
        self.steps = 0
        self.slot_steps = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit_all(self) -> None:
        progressed = True
        while progressed:
            progressed = False
            for slot in self.slots.free_slots():
                if not self.queue:
                    break
                req = self.queue.popleft()
                self.slots.admit(slot, req)
                first = self.prefill_fn(slot, req.prompt)
                req.generated.append(int(first))
                progressed = True
            # a 1-token request is already complete after prefill — retire
            # now so its slot can be reused this very step
            done = self.slots.retire_finished()
            if done:
                self.completed.extend(done)
                progressed = True

    def run_step(self) -> None:
        self._admit_all()
        active = self.slots.active_slots()
        if not active:
            return
        tokens = np.zeros((self.slots.capacity, 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots.request[i].generated[-1]
        active = self.slots.active_slots()
        if not active:
            return
        nxt = self.step_fn(tokens, self.slots.pos.copy())
        for i in active:
            self.slots.request[i].generated.append(int(nxt[i]))
            self.slots.pos[i] += 1
        self.steps += 1
        self.slot_steps += len(active)
        self.completed.extend(self.slots.retire_finished())

    def run_until_drained(self, max_steps: int = 100000) -> List[Request]:
        while (self.queue or self.slots.active_slots()) and self.steps < max_steps:
            self.run_step()
        return self.completed


def decode_loop_ppn(slots: int, steps: int):
    """The decode loop as a *cyclic* PPN: what the batcher above executes
    operationally, expressed in the paper's vocabulary so the self-timed
    engine can replay it.

    Two processes: ``prefill`` fires once per batch slot and seeds its
    state; ``decode`` fires once per (slot, step), reading the state token
    its own previous step emitted — the KV-cache feedback ``(s, t) →
    (s, t+1)`` that makes the process graph cyclic (a self-loop, the
    smallest SCC).  Decode's local order is step-major ``(t, s)``: the
    decode step advances ALL batch slots together, so the feedback
    channel's live frontier is one token per slot and its minimal capacity
    is exactly ``slots`` — shrinking it below that self-deadlocks the loop
    (decode blocks on its own full output before it reaches the instance
    whose pop would free a slot), which is precisely what
    ``validate(mode="selftimed")``'s negative direction must observe."""
    from ..core import v
    from ..core.ppn import PPN, Channel, Process
    from ..core.schedule import AffineSchedule

    ss, tt = np.meshgrid(np.arange(slots), np.arange(steps), indexing="ij")
    pts = np.stack([ss.ravel(), tt.ravel()], axis=1)        # (S·T, 2)
    sched = AffineSchedule(("s", "t"), [v("t") * slots + v("s")])
    procs = {
        "prefill": Process("prefill", ("s",),
                           AffineSchedule.identity(("s",)),
                           np.arange(slots)[:, None], stmt_rank=0),
        "decode": Process("decode", ("s", "t"), sched, pts, stmt_rank=1),
    }
    seed = np.arange(slots)[:, None]
    first = np.concatenate([seed, np.zeros_like(seed)], axis=1)
    fb_src = pts[pts[:, 1] < steps - 1]
    fb_dst = fb_src.copy()
    fb_dst[:, 1] += 1
    chans = [
        Channel("prefill", "decode", 0, "state", seed, first),
        Channel("decode", "decode", 0, "state", fb_src, fb_dst),
    ]
    return PPN("serve-decode", {}, procs, chans)
