"""Quickstart: the paper's algorithm end to end, then a short training run.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 100] \
        [--arch smollm-135m] [--validate] [--dsl] [--parametric] \
        [--paper-only] [--device cuda|cpu]

The port of the reference's ``examples/quickstart.py``:

1. Builds the paper's motivating Jacobi-1D PPN, tiles it, shows the broken
   FIFO channels, recovers them with FIFOIZE, prints buffer sizes
   (``--validate`` replays every verdict through the cuda backend's ring
   replay, kernel 3 on the card or its plain version with ``--device cpu``;
   ``--dsl`` and ``--parametric`` as in the reference).
2. Trains a reduced ~100M-family config with the full training substrate
   (microbatching, remat, AdamW, async checkpoints, fault-tolerant loop) on
   ``--device`` (the card by default).
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import List, Optional


def paper_demo(validate: bool = False, device=None):
    from repro_torch.core.analysis import analyze
    from repro_torch.core.polybench import jacobi_1d_paper

    print("=== 1. the paper's algorithm (Fig. 1 / Fig. 3) ===")
    case = jacobi_1d_paper(N=16, T=8, b1=4, b2=4)
    # the staged driver: one batched classification pass, one shared
    # classifier/sizing context threaded through every stage
    tiled = analyze(case).classify()
    print("after tiling:")
    for c in tiled.ppn.channels:
        print(f"  {c.name:32s} {tiled.patterns[c.name].value}")
    sized = tiled.fifoize().size(pow2=True)
    rep = sized.fifoize_report
    print(f"FIFOIZE: split {len(rep.split_ok)} channels "
          f"({len(rep.split_failed)} failed)")
    for c in sized.ppn.channels:
        print(f"  {c.name:32s} {sized.patterns[c.name].value:8s} "
              f"buffer={sized.sizes[c.name]}")
    print(sized.report().summary())
    if validate:
        # operational check: replay every verdict on the runtime simulator
        # (a FIFO verdict must pop in order, a broken one must NOT), and
        # confirm peak occupancy fits the planned buffers
        v = sized.validate(device=device).validation
        print(f"validate (trace replay through the cuda backend on "
              f"{device or 'cuda'}):")
        for row in v.channels:
            rej = f", rejected {list(row.rejected)}" if row.rejected else ""
            print(f"  {row.name:32s} {row.verdict:8s} confirmed on "
                  f"{row.lowering}: peak {row.peak} <= {row.slots} "
                  f"slots{rej}")
        print(v.summary())


def parametric_demo():
    """Symbolic-size analysis on the paper kernel: the verdicts are proved
    once for ALL sizes above a threshold, buffer capacities come out as
    closed forms, and the paper's concrete size is one instantiation."""
    from repro_torch.core import analyze, symbolic
    from repro_torch.core.polybench import jacobi_1d_paper

    print("\n=== parametric: jacobi-1d (Fig. 1) with N, T symbolic ===")
    case = jacobi_1d_paper()                 # N, T declared via Nest.param
    pa = analyze(case, sizes=symbolic).classify().fifoize().size(pow2=True)
    rep = pa.report()                        # instantiated at N=16, T=8
    doc = rep.parametric
    if doc["status"] != "symbolic":
        print(f"fell back to concrete analysis: {doc['reason']}")
        return
    for p, info in doc["params"].items():
        print(f"  {p}: proved for {p} >= {info['threshold']} "
              f"(stride {info['stride']})")
    print("  symbolic verdicts (proof status per flag):")
    for name, ch in doc["channels"].items():
        print(f"    {name:28s} {ch['pattern']:22s} "
              f"in-order:{ch['in_order']['status']:10s} "
              f"unicity:{ch['unicity']['status']}")
    print("  closed-form buffer capacities (pre-pow2):")
    for name, s in doc["sizes"].items():
        print(f"    {name:28s} {s['capacity']:18s} lead {s['lead']}")
    total = doc["total_capacity"]
    print(f"  total: {total['capacity']}  (~{total['lead']})")
    # the paper's size is just one evaluation of the template (microseconds)
    at_paper = pa.evaluate(N=16, T=8)
    print(f"  evaluated at the paper's N=16, T=8: "
          f"total {at_paper.total_slots} slots "
          f"(= concrete analysis, byte-identical)")
    pa.release()


def dsl_demo():
    """The same kernel authored both ways: a raw polyhedral spec (hand-built
    `Statement`s with hand-numbered 2d+1 schedules — the pre-`repro_torch.lang`
    format) vs the declarative builder, with byte-identical analysis."""
    from repro_torch.core import analyze, report_payload
    from repro_torch.core.affine import LinExpr, ge, lt, v
    from repro_torch.core.dataflow import Access, Kernel, Statement
    from repro_torch.core.registry import KernelCase
    from repro_torch.core.schedule import AffineSchedule
    from repro_torch.core.tiling import Tiling
    from repro_torch.lang import Nest

    N, T, b = 16, 8, 4
    C = LinExpr.const_expr
    print("\n=== DSL: jacobi-1d (Fig. 1) authored both ways ===")

    # -- the raw way: every schedule constant and boundary process by hand --
    til = Tiling(((1, 0), (1, 1)), (b, b))
    raw = Kernel("jacobi-1d-paper", {}, [
        Statement("load", ("i",), [ge(v("i"), 0), lt(v("i"), N + 2)],
                  AffineSchedule(("i",), [C(0), v("i"), C(0)]),
                  writes=[Access("a", (C(0), v("i")))]),
        Statement("compute", ("t", "i"),
                  [ge(v("t"), 1), lt(v("t"), T + 1),
                   ge(v("i"), 1), lt(v("i"), N + 1)],
                  AffineSchedule(("t", "i"), [C(1), v("t"), v("i")]),
                  writes=[Access("a", (v("t"), v("i")))],
                  reads=[Access("a", (v("t") - 1, v("i") - 1)),
                         Access("a", (v("t") - 1, v("i"))),
                         Access("a", (v("t") - 1, v("i") + 1))]),
        Statement("store", ("i",), [ge(v("i"), 1), lt(v("i"), N + 1)],
                  AffineSchedule(("i",), [C(2), v("i"), C(0)]),
                  reads=[Access("a", (C(T), v("i")))]),
    ])
    raw_case = KernelCase(raw, {"compute": til}, ("compute",))

    # -- the declarative way: program order IS the schedule ------------------
    k = Nest("jacobi-1d-paper")
    a = k.array("a", T + 1, N + 2)
    with k.loop("i", 0, N + 2) as i:
        k.stmt("load", writes=[a[0, i]])
    with k.loop("t", 1, T + 1) as t, k.loop("i", 1, N + 1) as i:
        k.stmt("compute", writes=[a[t, i]],
               reads=[a[t - 1, i - 1], a[t - 1, i], a[t - 1, i + 1]])
    with k.loop("i", 1, N + 1) as i:
        k.stmt("store", reads=[a[T, i]])
    k.tile("compute", til)

    run = lambda spec: (analyze(spec).classify().fifoize().size(pow2=True)
                        .report())
    raw_rep, dsl_rep = run(raw_case), run(k.case(compute=("compute",)))
    assert report_payload(raw_rep) == report_payload(dsl_rep), \
        "DSL and raw spec must analyze byte-identically"
    print("raw spec:", raw_rep.summary())
    print("repro_torch.lang:", dsl_rep.summary())
    print("reports byte-identical (modulo cache diagnostics) — see "
          "docs/frontend.md")


def train_demo(arch: str, steps: int, ckpt: str, device=None):
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.models import build
    from repro_torch.models.sharding import Rules
    from repro_torch.train.loop import train

    print(f"\n=== 2. train {arch} (reduced) for {steps} steps ===")
    bundle = configs.get(arch)
    cfg = reduced(bundle.model)
    par = bundle.parallel_for("train_4k", False).replace(num_microbatches=2)
    model = build(cfg, par)
    rules = Rules.make({"data": 1, "model": 1}, par)
    rep = train(model, rules, steps=steps, ckpt_dir=ckpt, lr=3e-3,
                ckpt_every=50, device=device)
    print(f"ran {rep.steps_run} steps; loss {rep.losses[0]:.3f} -> "
          f"{rep.final_loss:.3f}; stragglers={rep.stragglers}")
    return rep


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart_ckpt"))
    ap.add_argument("--paper-only", action="store_true",
                    help="run only the paper demo (no training)")
    ap.add_argument("--validate", action="store_true",
                    help="operationally validate every verdict and buffer "
                         "size by replaying its trace through a ring")
    ap.add_argument("--dsl", action="store_true",
                    help="show the paper kernel authored both ways (raw "
                         "spec vs repro_torch.lang) with byte-identical "
                         "analysis")
    ap.add_argument("--parametric", action="store_true",
                    help="symbolic-size analysis: verdicts proved for all "
                         "N, T above a threshold, closed-form capacities, "
                         "instantiated at the paper's size")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    paper_demo(validate=args.validate, device=args.device)
    if args.dsl:
        dsl_demo()
    if args.parametric:
        parametric_demo()
    if not args.paper_only:
        return train_demo(args.arch, args.steps, args.ckpt, args.device)
    return None


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
