"""The self-timed engine's capacity points: steps and stall attribution at
planned capacities, one slot under, and 25% over.

The counterpart of `benchmarks/bench_selftimed.py`.  Per target — the
stencil kernels (jacobi-1d, jacobi-2d, heat-3d) at their registry sizes,
exact (not pow2-rounded) sizing, and the cyclic vpp-blocked pipeline ring
— the network executes on the self-timed engine (concurrent policy) at
three capacity points:

* **planned** — `executable_capacities` for the kernels, the planner's
  per-part tick capacities for the ring;
* **planned_minus_1** — every bounded channel one slot tighter (floored
  at 0): expected to deadlock or slow down, the culprit attributed;
* **planned_plus_25pct** — a quarter more slack everywhere.

Each row holds ``completed``, ``steps``, ``fires``, ``throughput``
(fires/step, 4 decimals), ``stall_pct`` (2 decimals), the busiest stalling
channel, the host seconds of the run and, when the point deadlocks, the
culprit, blocking cycle and step.  Everything but the seconds is
deterministic.  The engine runs on the host.

    PYTHONPATH=src python -m repro_torch.bench.selftimed_points
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

#: the stencils of the reference benchmark, and its ring
KERNELS = ("jacobi-1d", "jacobi-2d", "heat-3d")
RING = dict(stages=4, microbatches=6, chunks=2, schedule="vpp-blocked")
POINTS = ("planned", "planned_minus_1", "planned_plus_25pct")


def _slack(caps: Dict[str, Optional[int]], delta_slots: int = 0,
           scale: float = 1.0) -> Dict[str, Optional[int]]:
    """Planned capacities shifted by ``delta_slots`` then scaled (rounded
    up); unbounded (late) channels stay unbounded, bounded ones floor at
    zero so planned−1 really bites single-slot channels."""
    out: Dict[str, Optional[int]] = {}
    for name, s in caps.items():
        if s is None:
            out[name] = None
        else:
            out[name] = max(0, int(-(-(s + delta_slots) * scale // 1)))
    return out


def _measure(ppn, caps: Dict[str, Optional[int]]) -> Dict[str, object]:
    from ..runtime.selftimed import execute_ppn

    t0 = time.perf_counter()
    rep = execute_ppn(ppn, caps, policy="concurrent", on_deadlock="report")
    dt = time.perf_counter() - t0
    stalled = [(c.name, c.stalls) for c in rep.channels if c.stalls]
    stalled.sort(key=lambda kv: -kv[1])
    row: Dict[str, object] = {
        "completed": rep.completed,
        "steps": rep.steps,
        "fires": rep.fires,
        "throughput": round(rep.throughput, 4),
        "stall_pct": round(100 * rep.stall_ratio, 2),
        "busiest_stall": (stalled[0][0] if stalled else None),
        "wall_seconds": round(dt, 4),
    }
    if rep.deadlock is not None:
        row["deadlock"] = {"culprit": rep.deadlock.culprit,
                           "cycle": rep.deadlock.cycle_channels(),
                           "step": rep.deadlock.step}
    return row


def targets():
    """``(label, ppn, planned capacities)`` of the four targets."""
    import repro_torch.core.polybench  # noqa: F401  (populate the registry)
    from ..comm.planner import PipelineSpec, ring_executable
    from ..core.analysis import analyze
    from ..core.registry import get
    from ..runtime.selftimed.validate import executable_capacities

    out = []
    for name in KERNELS:
        a = analyze(get(name)).classify().fifoize().size(pow2=False)
        out.append((name, a.ppn, executable_capacities(a)))
    ppn, caps = ring_executable(PipelineSpec(**RING))
    out.append(("ring-vpp", ppn, caps))
    return out


def points(ppn, caps: Dict[str, Optional[int]]) -> Dict[str, dict]:
    """The three capacity points of one target, by `POINTS` name."""
    slacks = {"planned": _slack(caps),
              "planned_minus_1": _slack(caps, delta_slots=-1),
              "planned_plus_25pct": _slack(caps, scale=1.25)}
    return {point: _measure(ppn, c) for point, c in slacks.items()}


def deterministic(row: Dict[str, object]) -> Dict[str, object]:
    """A point's row without its host seconds."""
    return {k: v for k, v in row.items() if k != "wall_seconds"}


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    for label, ppn, caps in targets():
        print(json.dumps({"target": label, "points": points(ppn, caps)}))


if __name__ == "__main__":
    main()
