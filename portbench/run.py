#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA card it is started
on, and print the result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cells, configurations and metrics are
those of `BENCHMARK.json`; the program is `src/repro_torch`.  Set-up (from
the process's start to the first timed job) is ``setup_s``; whole jobs then
run back to back for ``--seconds``.  With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a further traced window of whole jobs.  The numbers compared with the
reference are printed beside their limits on standard error and under
``checks`` in the line.

Exit codes: 0 with a result line (``correct`` may be false); 2 where the
run cannot be made (no CUDA card, fewer cards than the cell asks for, no
program in the checkout); 3 where a module of the JAX stack or the
reference package was loaded; 1 on any other failure.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: no program at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    torch_import = time.perf_counter() - T0

    from portbench.lib.harness import ForbiddenModules, run_cell
    from portbench.lib.manifest import Manifest

    cell = Manifest.load(ROOT).cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), T0,
                          spans={"torch_import": torch_import})
    except ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
