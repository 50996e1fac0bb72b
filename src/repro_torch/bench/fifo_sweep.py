"""The Fig. 3 kernel's launch swept, as built.

Times kernel 4 (``csrc/stencil_fifo.cu``, its C entry point at a
`kernels.stencil_fifo.kernel.fifo_launch` shape) with fewer blocks in
flight than its default launch (so more rounds, the last worker's FIFO
wrapping to worker 0 between them) and with its blocks split over other
numbers of threads (8, 4 or 2 cells a thread: fewer cells, more warps and
channels).  At PolyBench
EXTRALARGE (N = 4000, steps = block = 8), at the Fig. 3 rows (1024, 128)
and (4096, 256), and at N = 64000 (8001 blocks of 8: eight rounds by
default): launches queued back to back and timed with CUDA events, the
device's time and not the wrapper's host time.  Every output must equal
the default launch's exactly.  Needs a CUDA device and ``nvcc``; without a
device it exits 2.

    PYTHONPATH=src python -m repro_torch.bench.fifo_sweep [--seed N]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .ring_sweep import launch_ms

#: (N, block = steps)
SHAPES = ((4000, 8), (1024, 128), (4096, 256), (64000, 8))
#: divisors of the most workers a split allows, and the cells a thread
FEWER_WORKERS = (1, 2, 4, 8)
CELLS = (8, 4, 2)


def rows(seed: int = 0):
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.stencil_fifo import kernel as sf

    rng = np.random.default_rng(seed)
    out = []
    for n, block in SHAPES:
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             ).cuda()
        base = sf.fifo_launch(n, block)
        want = sf._jacobi_fifo_with(x, block, block, base)
        y = torch.empty_like(x)
        stream = cuda_lib.raw_stream(x.device)
        launches = []
        for cells in CELLS:
            tpw = -(-block // cells)
            if tpw > sf.MAX_THREADS or (tpw > 1 and block < 2 * tpw):
                continue
            for wdiv in FEWER_WORKERS:
                g = max(1, sf.fifo_launch(n, block, None, tpw).workers // wdiv)
                launches.append(sf.fifo_launch(n, block, g, tpw))
        for launch in dict.fromkeys(launches):
            run = lambda: cuda_lib.STENCIL_FIFO(
                x.data_ptr(), y.data_ptr(), n, block, block, launch.workers,
                launch.threads_per_worker, stream, launches=0)
            ms = launch_ms(run, 20)
            if not torch.equal(y, want):
                raise AssertionError(f"({n}, {block}) {launch}: differs")
            out.append({"n": n, "block": block, "workers": launch.workers,
                        "threads_per_worker": launch.threads_per_worker,
                        "threads": launch.threads, "rounds": launch.rounds,
                        "waves": launch.waves, "default": launch == base,
                        "ms": ms})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fifo_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}")
    for row in rows(args.seed):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
