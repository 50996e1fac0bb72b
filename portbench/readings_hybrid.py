#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, for a served-request
cell (`drivers/hybrid_request.py`), on the card at the cell's own size: the
program's ``max_rel_err`` and ``route_margin`` over many seeds (the lower
readings), the controls' (the upper readings: the reference computed at a
lower precision than the configuration states, held to the float32
reference), and two faults of the program's router.

    python3 portbench/readings_hybrid.py --workload <cell> [--seeds 12] \
        [--control-seeds 3] [--base-seed N] [--out FILE]

From the root of a checkout, on a CUDA card.  Each seed draws its own
weights and serves request 0 of a run with that seed, after one warm-up
request.  The controls, on the first ``--control-seeds`` seeds:

- ``fp8``: every sublayer's normed input and its output rounded to float8
  e4m3, the precision below the configuration's bf16 activations;
- ``bf16_state``: the Mamba scan's decay and state in bf16 in place of
  float32.

A control's ``max_rel_err`` is taken with the program's routing, as the
check takes the program's; its ``route_margin`` is that of its own
routing under the float32 reference.  The faults, on the first seed: the
program with its top-2 gates renormalized (the capacity MoE's rule), and
with capacity routing at factor 1.25 (tokens dropped).  The benchmark's
runs do not run this.  Prints one JSON line and writes it to ``--out``.
"""
import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def fp8(a):
    """float32 ``a`` rounded to float8 e4m3, kept in float32."""
    import torch

    return a.to(torch.float8_e4m3fn).to(torch.float32)


def controls():
    import torch

    return {"fp8": {"level": fp8}, "bf16_state": {"state_dtype":
                                                  torch.bfloat16}}


def make_driver(bench, workload: str, seed: int, device):
    from portbench.lib.harness import Context
    from portbench.lib.plugins import load_module

    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    ctx = Context(workload, seed, config, bench.mix(cell["traffic"]), device)
    driver = load_module(bench.folder / "drivers", config["driver"]).make(
        bench.folder, ctx, sys.stderr)
    driver.setup(ctx)
    return driver


def control_readings(driver, sample) -> dict:
    from portbench.lib.compare import max_rel_err

    prompt, tokens, _, calls = sample
    routes = driver.layer_routes(calls)
    want = driver.reference_logits(prompt, tokens, routes)
    out = {}
    for name, knobs in controls().items():
        got = driver.reference_logits(prompt, tokens, routes, **knobs)
        own, forced = {}, {}
        driver.reference_logits(prompt, tokens, record=own, **knobs)
        driver.reference_logits(prompt, tokens, own["routes"], record=forced)
        out[name] = {"max_rel_err": max_rel_err(got, want),
                     "route_margin": forced["margin"]}
    return out


def fault_readings(driver, seed: int) -> dict:
    """The program with a wrong router, on request 0 of ``seed``."""
    model = driver.model
    out = {}
    for name, change in (("renormalized_gates", {"moe_norm_topk": True}),
                         ("capacity_1.25", {"capacity_factor": 1.25})):
        driver.model = dataclasses.replace(
            model, cfg=dataclasses.replace(model.cfg, **change))
        try:
            sample = driver.job(0, seed=seed)
        finally:
            driver.model = model
        prompt, tokens, logits, calls = sample
        if not calls:   # the capacity path records no routes: its own
            record = {}
            want = driver.reference_logits(prompt, tokens, record=record)
            from portbench.lib.compare import max_rel_err
            out[name] = {"max_rel_err": max_rel_err(
                logits[:, :driver.cfg.vocab_size], want)}
        else:
            err, margin = driver.compare(sample)
            out[name] = {"max_rel_err": err, "route_margin": margin}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--base-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.lib.manifest import Manifest
    from portbench.readings import card_line

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    bench = Manifest.load(ROOT)
    device = torch.device("cuda", 0)
    out = {"workload": args.workload, "card": card_line(), "program": {},
           "control": {}, "faults": {}}
    for k in range(args.seeds):
        seed = args.base_seed + 7919 * k
        t = time.perf_counter()
        driver = make_driver(bench, args.workload, seed, device)
        sample = driver.job(0)
        err, margin = driver.compare(sample)
        out["program"][seed] = {"max_rel_err": err, "route_margin": margin}
        if k < args.control_seeds:
            out["control"][seed] = control_readings(driver, sample)
        if k == 0:
            out["faults"][seed] = fault_readings(driver, seed)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s "
              f"{out['program'][seed]} {out['control'].get(seed)} "
              f"{out['faults'].get(seed)}", file=sys.stderr, flush=True)
        del driver, sample
        gc.collect()
        torch.cuda.empty_cache()
    for key in ("max_rel_err", "route_margin"):
        out[f"lower.{key}"] = max(r[key] for r in out["program"].values())
        out[f"upper.{key}"] = {name: min(c[name][key] for c in
                                         out["control"].values())
                               for name in controls()}
    out["limits"] = bench.config(bench.cell(args.workload)["config"])[
        "limits"]
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
