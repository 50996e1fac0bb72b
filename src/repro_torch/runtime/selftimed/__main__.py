"""CLI: execute PPNs self-timed and render the observability report.

    PYTHONPATH=src python -m repro_torch.runtime.selftimed --report \
        [--kernel jacobi-1d | --ring | --decode] [--policy concurrent]
        [--shrink CHANNEL[=N]] [--inject KIND:CHANNEL@N] [--timeline]
        [--json]

Default (no target flag) runs a small demo: jacobi-1d plus the cyclic
pipeline ring.  ``--shrink`` reruns with the named channel's planned
capacity reduced by N (default 1) slots — the way to *watch* a deadlock
report instead of reading about one.  ``--inject`` (repeatable) arms the
resilience guards and injects declarative faults
(``drop:CHANNEL@N``, ``duplicate:...``, ``reorder:...``, ``corrupt:...``,
``capacity:...``, ``stall:PROCESS@N*SPAN``, ``crash:PROCESS@N``); exit
code 0 when the run recovers (a degraded-but-correct run prints a notice),
1 when the fault is unrecovered.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Tuple

from ...core.analysis import analyze
from ...core.ppn import PPN
from .engine import execute_ppn
from .validate import executable_capacities, selftimed_validate


def _kernel_target(name: str) -> Tuple[PPN, Dict[str, int], Dict[str, str]]:
    from ...core.polybench import get
    from ..resilience import channel_lowerings
    a = analyze(get(name)).classify().fifoize().size(pow2=True)
    return a.ppn, executable_capacities(a), channel_lowerings(a)


def _ring_target(stages: int, microbatches: int, chunks: int,
                 schedule: str) -> Tuple[PPN, Dict[str, int], None]:
    from ...comm.planner import PipelineSpec, ring_executable
    ppn, caps = ring_executable(PipelineSpec(
        stages=stages, microbatches=microbatches, chunks=chunks,
        schedule=schedule))
    return ppn, caps, None


def _decode_target(slots: int, steps: int
                   ) -> Tuple[PPN, Dict[str, int], None]:
    from ...serve.batching import decode_loop_ppn
    a = analyze(decode_loop_ppn(slots, steps)).classify().size(pow2=True)
    return a.ppn, executable_capacities(a), None


def _run_injected(ppn: PPN, caps: Dict[str, int],
                  lows: Optional[Dict[str, str]], args) -> int:
    from ..resilience import FaultPlan, FaultSpecError, run_guarded
    try:
        plan = FaultPlan.parse(args.inject)
        plan.validate_against([c.name for c in ppn.channels],
                              list(ppn.processes))
    except FaultSpecError as e:
        sys.stderr.write(f"{e}\n")
        return 2
    oracle = run_guarded(ppn, caps, FaultPlan(), lows, policy=args.policy)
    gr = run_guarded(ppn, caps, plan, lows, policy=args.policy,
                     oracle=oracle, record_timeline=args.timeline)
    r = gr.resilience
    if args.json:
        print(json.dumps({"run": gr.run.as_dict(),
                          "resilience": r.as_dict()},
                         indent=1, sort_keys=True))
    elif args.report:
        print(gr.run.render())
        print(r.render())
    else:
        print(r.summary())
    if r.status == "degraded":
        sys.stderr.write(
            f"notice: run degraded but correct — "
            f"{len(r.swaps)} hot-swap(s), {len(r.spills)} spill(s)\n")
    return 1 if r.status == "unrecovered" else 0


def _run(ppn: PPN, caps: Dict[str, int],
         lows: Optional[Dict[str, str]], args) -> int:
    for spec in args.shrink or []:
        name, _, n = spec.partition("=")
        if name not in caps:
            sys.stderr.write(f"no channel {name!r} (have: "
                             f"{sorted(caps)})\n")
            return 2
        caps[name] = max(caps[name] - (int(n) if n else 1), 0)
    if args.inject:
        return _run_injected(ppn, caps, lows, args)
    rep = execute_ppn(ppn, caps, policy=args.policy,
                      record_timeline=args.timeline, on_deadlock="report")
    if args.json:
        print(json.dumps(rep.as_dict(), indent=1, sort_keys=True))
    elif args.report:
        print(rep.render())
    else:
        print(rep.summary())
    return 0 if rep.completed else 1


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.selftimed", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--report", action="store_true",
                    help="render the full observability report")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    ap.add_argument("--kernel", help="run a registered PolyBench kernel")
    ap.add_argument("--ring", action="store_true",
                    help="run the cyclic pipeline ring under planned "
                         "tick capacities")
    ap.add_argument("--decode", action="store_true",
                    help="run the continuous-batching decode loop (cyclic "
                         "token feedback)")
    ap.add_argument("--policy", default="concurrent",
                    choices=("sequential", "concurrent"))
    ap.add_argument("--shrink", action="append", metavar="CHANNEL[=N]",
                    help="shrink a channel's planned capacity by N slots "
                         "(repeatable; watch the deadlock report)")
    ap.add_argument("--inject", action="append",
                    metavar="KIND:TARGET[@AT][*N]",
                    help="arm the resilience guards and inject a fault "
                         "(repeatable), e.g. drop:init->upd.C[0]@1 or "
                         "stall:upd@2*3; exit 0 on recovery, 1 when "
                         "unrecovered")
    ap.add_argument("--timeline", action="store_true",
                    help="record per-step fire/stall timelines")
    ap.add_argument("--validate", action="store_true",
                    help="run the full validate(mode='selftimed') checks "
                         "instead of a single execution")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=6)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--schedule", default="vpp-blocked",
                    choices=("gpipe", "vpp-blocked", "mixed"))
    ap.add_argument("--slots", type=int, default=4,
                    help="--decode: batch slots")
    ap.add_argument("--steps", type=int, default=8,
                    help="--decode: decode steps per slot")
    args = ap.parse_args(argv)

    if args.validate and args.kernel:
        from ...core.polybench import get
        a = (analyze(get(args.kernel)).classify().fifoize().size(pow2=True)
             .validate(mode="selftimed"))
        print(a.selftimed.summary())
        return 0

    targets = []
    if args.kernel:
        targets.append(("kernel " + args.kernel,
                        _kernel_target(args.kernel)))
    if args.ring:
        targets.append((f"pipeline ring ({args.schedule}, "
                        f"S={args.stages} M={args.microbatches} "
                        f"C={args.chunks})",
                        _ring_target(args.stages, args.microbatches,
                                     args.chunks, args.schedule)))
    if args.decode:
        targets.append((f"decode loop (B={args.slots}, T={args.steps})",
                        _decode_target(args.slots, args.steps)))
    if not targets:                      # demo: one acyclic, one cyclic
        targets = [("kernel jacobi-1d", _kernel_target("jacobi-1d")),
                   (f"pipeline ring (vpp-blocked, S=4 M=6 C=2)",
                    _ring_target(4, 6, 2, "vpp-blocked"))]

    demo = not (args.kernel or args.ring or args.decode)
    rc = 0
    for i, (label, (ppn, caps, lows)) in enumerate(targets):
        if i:
            print()
        print(f"== {label} ==")
        rc = max(rc, _run(ppn, dict(caps), lows, args))
    if demo and args.report and not (args.inject or args.shrink):
        # resilience demo: one token dropped in flight, healed by the
        # channel guards
        from ..resilience import FaultPlan, run_guarded
        spec = "drop:sb->sa.B[0]@1"
        print(f'\n== resilience demo: --inject "{spec}" on jacobi-1d ==')
        ppn, caps, lows = targets[0][1]
        oracle = run_guarded(ppn, caps, FaultPlan(), lows,
                             policy=args.policy)
        gr = run_guarded(ppn, caps, FaultPlan.parse([spec]), lows,
                         policy=args.policy, oracle=oracle)
        print(gr.resilience.render())
    return rc


if __name__ == "__main__":
    sys.exit(main())
