"""The communication planner: the paper's algorithm applied to the
distributed runtime's own channels.

A distributed schedule (pipeline stages × microbatches × virtual-stage
chunks, or sequence-parallel halo exchanges) is expressed as a PPN —
processes with iteration domains + affine local schedules, channels = the
inter-device dataflow.  The paper's classifier decides which channels are
FIFO; FIFOIZE recovers FIFOs broken by the schedule's "tiling" (the chunk
dimension of an interleaved pipeline plays exactly the role of the loop
tiling in the paper: a Megatron-style depth-first consumer interleave breaks
the producer's emission order, and splitting the channel per chunk restores
per-channel FIFO order).

Verdicts map to implementations through the lowering registry — the single
verdict→lowering table is `repro_torch.runtime.lowering.PATTERN_LOWERING`; the
trace-driven reference simulator is `repro_torch.runtime.simulator`.  The
collectives that carry the ring are `comm.channels` and `comm.pipeline`,
on a stage group (`comm.group`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.analysis import ChannelPlan, analyze
from ..core.deprecation import deprecated_shim
from ..core.patterns import ChannelClassifier, Pattern, _classify_channel
from ..core.ppn import PPN, Channel, Process
from ..core.schedule import AffineSchedule
from ..core.sizing import tick_capacity
# re-exported for backward compatibility — these moved to the core
from ..core.split import NotApplicable, split_by_tile_pair  # noqa: F401
from ..core.tiling import Tiling
from ..core import v

_tick_capacity = tick_capacity                 # old private name, kept alive


# =========================================================== pipeline model

@dataclass
class PipelineSpec:
    stages: int
    microbatches: int
    chunks: int = 1                # virtual pipeline (interleaving) factor
    block: int = 1                 # vpp depth-first block size v
    schedule: str = "gpipe"        # gpipe | vpp-blocked | mixed


def _order(spec: PipelineSpec, stage: int, c: np.ndarray, m: np.ndarray
           ) -> np.ndarray:
    """Local execution order of (chunk, microbatch) on one device."""
    C, M, vblk = spec.chunks, spec.microbatches, spec.block
    if spec.schedule == "gpipe":
        return m * C + c                       # microbatch-major
    if spec.schedule == "vpp-blocked":
        # Megatron-style depth-first blocks: run chunk c for a block of v
        # microbatches before switching chunks.
        blk, within = m // vblk, m % vblk
        return blk * (C * vblk) + c * vblk + within
    if spec.schedule == "mixed":
        # The last stage flushes breadth-first (all microbatches of chunk c,
        # then chunk c+1 — loss/flush order), earlier stages run depth-first
        # (microbatch-major).  The wraparound channel's producer/consumer
        # interleavings disagree → out-of-order until split per chunk.
        if stage == spec.stages - 1:
            return c * M + m                   # chunk-major
        return m * C + c
    raise ValueError(spec.schedule)


def pipeline_ppn(spec: PipelineSpec) -> PPN:
    """PPN of the forward activation flow: device s → s+1 (same chunk) and
    the wraparound s = S-1 → 0 (chunk c → c+1)."""
    C, M, S = spec.chunks, spec.microbatches, spec.stages
    cc, mm = np.meshgrid(np.arange(C), np.arange(M), indexing="ij")
    pts = np.stack([cc.ravel(), mm.ravel()], axis=1)       # (C·M, 2)

    procs: Dict[str, Process] = {}
    sched = AffineSchedule(("c", "m"), [_order_expr(spec)])
    tiling = Tiling(((1, 0),), (1,))                       # φ = chunk
    for s in range(S):
        procs[f"stage{s}"] = Process(f"stage{s}", ("c", "m"), sched, pts,
                                     tiling=tiling, stmt_rank=s)

    chans: List[Channel] = []
    for s in range(S - 1):
        chans.append(Channel(f"stage{s}", f"stage{s+1}", 0, "act",
                             pts.copy(), pts.copy()))
    if C > 1:
        wrap = pts[pts[:, 0] < C - 1]
        dst = wrap.copy()
        dst[:, 0] += 1
        chans.append(Channel(f"stage{S-1}", "stage0", 0, "act", wrap, dst))
    return PPN("pipeline", {}, procs, chans)


def _order_expr(spec: PipelineSpec):
    """Affine local order for the enumeration backend's Process.local_ts —
    exact for gpipe; for vpp-blocked we use the (c, m) identity and rely on
    pipeline_ppn's custom timestamps below."""
    return v("m") * spec.chunks + v("c")


class _PipeProcess(Process):
    """Process whose local order is the device's actual interleaved execution
    order `t` — unlike the paper's tiled loops, a pipeline device does NOT
    execute a chunk ("tile") atomically, so φ must not prefix the order; the
    tiling is used by SPLIT only."""

    def __init__(self, spec: PipelineSpec, *a, **kw):
        super().__init__(*a, **kw)
        self._spec = spec

    def local_ts(self, pts: np.ndarray, params) -> np.ndarray:
        t = _order(self._spec, self.stmt_rank, pts[:, 0], pts[:, 1])
        return t[:, None]

    def global_ts(self, pts: np.ndarray, params) -> np.ndarray:
        """(stage, interleaved order) — keeps the global timestamps coherent
        with the overridden local order, so the runtime simulator's replay of
        an (acyclic) pipeline PPN pops in the device's real execution order
        instead of the affine expression's."""
        t = _order(self._spec, self.stmt_rank, pts[:, 0], pts[:, 1])
        rank = np.full((len(pts), 1), self.stmt_rank, dtype=np.int64)
        return np.concatenate([rank, t[:, None]], axis=1)


def analyze_pipeline(spec: PipelineSpec) -> Tuple[PPN, List[ChannelPlan]]:
    """Plan every channel of the pipeline PPN via the staged driver
    (`analyze(...).plan('pipeline')`): tick capacities, depth- then
    chunk-splitting, one shared classifier."""
    ppn = pipeline_ppn(spec)
    for name, p in list(ppn.processes.items()):
        ppn.processes[name] = _PipeProcess(
            spec, p.name, p.dims, p.schedule, p.pts, p.tiling, p.stmt_rank)
    a = analyze(ppn).plan(topology="pipeline")
    return ppn, list(a.plans)


def ring_executable(spec: PipelineSpec
                    ) -> Tuple[PPN, Dict[str, Optional[int]]]:
    """The planned ring in executable form: the pipeline PPN with split
    plans expanded into their recovered *parts* — one bounded queue per part
    at the per-part planned slots, the operational shape the pipeline
    ring implements — plus the per-channel capacity map (tick capacities,
    floored at one slot)."""
    from ..core.split import split_channel
    from ..runtime.lowering import CHUNK_SPLIT, DEPTH_SPLIT
    ppn, plans = analyze_pipeline(spec)
    splitters = {DEPTH_SPLIT: split_channel, CHUNK_SPLIT: split_by_tile_pair}
    plan_by = {p.name: p for p in plans}
    chans: List[Channel] = []
    caps: Dict[str, Optional[int]] = {}
    for ch in ppn.channels:
        plan = plan_by[ch.name]
        if plan.split:
            slots = {depth: size for depth, _, size in plan.parts}
            for part in splitters[plan.lowering](ppn, ch):
                chans.append(part)
                caps[part.name] = max(1, int(slots[part.depth]))
        else:
            chans.append(ch)
            caps[ch.name] = max(1, int(plan.buffer_slots))
    return PPN(ppn.kernel_name, ppn.params, ppn.processes, chans), caps


def ring_selftimed(spec: PipelineSpec, policy: str = "concurrent",
                   shrink: Optional[Dict[str, int]] = None,
                   record_timeline: bool = False,
                   on_deadlock: str = "raise"):
    """Execute the planned pipeline ring *self-timed*: every inter-stage
    channel a bounded queue at the planner's tick capacity, every stage
    firing on data availability alone.  This is the operational check for
    the one topology the trace replay cannot cover — the wraparound channel
    (``chunks > 1``) makes the process graph cyclic, so whether the planned
    slots deadlock is a property of the *dynamics*, not of any single
    channel's trace.

    ``shrink`` overrides planned capacities per (part) channel name (the
    negative direction: shrinking the wraparound channel must deadlock,
    naming it).  Returns the `SelfTimedReport`; ``on_deadlock="raise"``
    raises `DeadlockError` carrying it.

    The check has teeth in both directions: the ``"mixed"`` schedule's
    flush-order forward channel genuinely needs one slot more than its tick
    capacity (the tick model shifts each late read independently and misses
    the consumer-order cascade) — this function observes that as a
    structural deadlock naming the channel, where the trace replay would
    happily replay each part."""
    from ..runtime.selftimed import execute_ppn   # numpy-only, lazy: no
    exec_ppn, caps = ring_executable(spec)        # comm<->runtime cycle
    if shrink:
        unknown = sorted(set(shrink) - set(caps))
        if unknown:
            raise KeyError(f"shrink names unknown channel(s) {unknown} "
                           f"(planned: {sorted(caps)})")
        caps.update(shrink)
    return execute_ppn(exec_ppn, caps, policy=policy,
                       record_timeline=record_timeline,
                       on_deadlock=on_deadlock)


# ===================================================== sequence-parallel halo

@dataclass
class SPHaloSpec:
    """Sequence-parallel state stream: shard boundaries cross a uniform
    dependence of distance `halo` (Mamba/RWKV state: halo=1 per block;
    stencil: halo = radius)."""
    shards: int
    blocks_per_shard: int
    halo: int = 1


def sp_halo_ppn(spec: SPHaloSpec) -> PPN:
    """Processes = sequence shards; iteration = local block index b; channel
    shard i → i+1 carries the last `halo` block states."""
    B = spec.blocks_per_shard
    pts = np.arange(B)[:, None]
    procs = {f"shard{i}": Process(f"shard{i}", ("b",),
                                  AffineSchedule.identity(("b",)), pts,
                                  tiling=Tiling(((1,),), (B,)), stmt_rank=i)
             for i in range(spec.shards)}
    chans = []
    for i in range(spec.shards - 1):
        src = np.arange(B - spec.halo, B)[:, None]
        dst = np.arange(0, spec.halo)[:, None]
        chans.append(Channel(f"shard{i}", f"shard{i+1}", 0, "state", src, dst))
    return PPN("sp-halo", {}, procs, chans)


def analyze_sp_halo(spec: SPHaloSpec) -> Tuple[PPN, List[ChannelPlan]]:
    ppn = sp_halo_ppn(spec)
    a = analyze(ppn).plan(topology="pipeline")
    return ppn, list(a.plans)


# ================================================================ shared bits

@deprecated_shim("analyze(ppn).classify()")
def classify_pattern(ppn: PPN, ch: Channel,
                     clf: Optional[ChannelClassifier] = None) -> Pattern:
    if clf is not None:
        return clf.classify(ch)
    return _classify_channel(ppn, ch)


def plan_report(plans: List[ChannelPlan]) -> str:
    lines = [f"{'channel':34s} {'before':22s} {'lowering':18s} slots  parts"]
    for p in plans:
        lines.append(f"{p.name:34s} {p.pattern_before:22s} {p.lowering:18s} "
                     f"{p.buffer_slots:5d}  {p.parts}")
    cheap = sum(p.is_cheap for p in plans)
    lines.append(f"-- {cheap}/{len(plans)} channels lowered to FIFO streams")
    return "\n".join(lines)
