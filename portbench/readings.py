#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, on the card at each
cell's own size: the program's ``max_rel_err`` over many seeds (the lower
reading), the control's (the reference run in place of the program at a
lower precision: TF32 and bfloat16 levels; the upper reading), and three
faults of the timed path.

    python3 portbench/readings.py --workloads <cell>[,<cell>…] \
        [--seeds 12] [--control-seeds 3] [--base-seed N] [--out FILE]

From the root of a checkout, on a CUDA card.  Each seed's job is job 0 of
a run with that seed, the input a run would make.  The benchmark's runs do
not run this.  Prints one JSON line a cell and writes them all to
``--out``.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def faults(driver, seed: int) -> dict:
    """``max_rel_err`` of three faults of the timed path on seed ``seed``:
    the state returned unchanged, half the array left as it came in, and
    (on the ring) the channel between blocks narrowed to one item."""
    import torch

    from portbench.lib.compare import max_rel_err

    want = driver.reference_job(seed, 0)
    x = driver.input(seed, 0)
    y = driver.job(0, seed=seed)
    half = y.clone()
    half[half.shape[0] // 2:] = x[x.shape[0] // 2:]
    out = {"unchanged": max_rel_err(x, want),
           "half_left_out": max_rel_err(half, want)}
    if driver.compiled.mode == "fifo-ring":
        z = x
        for _ in range(driver.sweeps // driver.steps):
            z = driver.compiled(z, driver.steps, driver.steps, halo=1)
        if z.is_cuda:
            torch.cuda.synchronize()
        out["ring_halo_1"] = max_rel_err(z, want)
    return out


def readings(workload: str, seeds, control_seeds, root: Path = ROOT,
             device=None) -> dict:
    """The readings of ``workload`` on ``device`` (the card by default)."""
    import torch

    from portbench.lib.compare import CONTROLS, max_rel_err, sweeps
    from portbench.lib.harness import Context
    from portbench.lib.manifest import Manifest
    from portbench.lib.plugins import load_module

    bench = Manifest.load(root)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    ctx = Context(workload, seeds[0], config, bench.mix(cell["traffic"]),
                  torch.device("cuda", 0) if device is None else device)
    driver = load_module(bench.folder / "drivers", config["driver"]).make(
        bench.folder, ctx, sys.stderr)
    t = time.perf_counter()
    driver.setup(ctx)
    out = {"workload": workload, "card": card_line(),
           "setup_s": time.perf_counter() - t, "program": {},
           "control": {name: {} for name in CONTROLS}, "faults": {}}
    for s in seeds:
        y = driver.job(0, seed=s)
        out["program"][s] = max_rel_err(y, driver.reference_job(s, 0))
        del y
    for s in control_seeds:
        want = driver.reference_job(s, 0)
        x = driver.input(s, 0)
        for name, level in CONTROLS.items():
            got = sweeps(driver.reference.sweep, x, driver.sweeps, level)
            out["control"][name][s] = max_rel_err(got, want)
        out["faults"][s] = faults(driver, s)
    prog = list(out["program"].values())
    ctrl = [v for c in out["control"].values() for v in c.values()]
    out["lower"] = max(prog)
    out["upper"] = min(ctrl)
    out["limit"] = config["limits"]["max_rel_err"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--base-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    seeds = [args.base_seed + 7919 * k for k in range(args.seeds)]
    results = []
    for workload in args.workloads.split(","):
        r = readings(workload, seeds, seeds[:args.control_seeds])
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
