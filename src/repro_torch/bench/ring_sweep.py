"""The ring kernel's launch shape swept, as built.

Times `runtime.cuda_codegen.ring_stencil`'s kernel (``csrc/ring_stencil.cu``)
at its cluster or grid launch with 8, 4, 2 and 1 items a thread, and in
each launch mode: 2, 4, 8 and 16 CTAs in one cluster with the tiles in
shared memory, where they fit, 16 to 132 CTAs in a cooperative grid with
the tiles in the scratch, and 33 to 132 CTAs holding blocks in flight (the
wave), where a block fits one CTA.  At the main path's shapes (PolyBench
EXTRALARGE jacobi-2d and heat-3d, time tile steps = block = 8), one launch
at a time with CUDA events; every output must equal the kernel's at its
default launch exactly.
Needs a CUDA device and ``nvcc``; without a device it exits 2.

    PYTHONPATH=src python -m repro_torch.bench.ring_sweep [--seed N]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

SHAPES = {"jacobi-2d": (2800, 2800), "heat-3d": (200, 200, 200)}
STEPS = BLOCK = 8
CLUSTERS = (2, 4, 8, 16)
GRIDS = (16, 33, 66, 132)
WAVES = (33, 66, 132)


def launch_ms(launch, reps: int) -> float:
    """CUDA-event time of one of ``reps`` launches queued back to back,
    after one warm-up launch."""
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rows(seed: int = 0):
    from repro_torch.runtime import cuda_codegen as cg

    rng = np.random.default_rng(seed)
    card = cg.ring_card(torch.device("cuda"))
    out = []
    for stencil, shape in SHAPES.items():
        p = cg.STENCIL_PROGRAMS[stencil]
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).cuda()
        want = cg.ring_stencil(x, p, STEPS, BLOCK, STEPS + 1, 2)
        d2 = cg._inner_dims(shape)[1]
        base = cg.ring_launch(shape, BLOCK, STEPS + 1, 2, card)
        launches = []
        for seg in cg.SEGMENTS:
            threads, _ = cg._ring_threads(base.rows * d2, BLOCK // seg,
                                          card.max_threads[seg])
            launches.append(("items_a_thread", seg, dataclasses.replace(
                base, threads=threads, segments=BLOCK // seg)))
        for mode, counts in (("shared", CLUSTERS), ("grid", GRIDS),
                             ("wave", WAVES)):
            for ctas in counts:
                try:
                    launches.append(("ctas", ctas, cg._ring_launch(
                        shape, BLOCK, STEPS + 1, 2, card, ctas, mode,
                        steps=STEPS)))
                except ValueError:
                    continue              # the tiles or the block fit no CTA
        for knob, value, launch in launches:
            run = lambda: cg._ring_stencil_with(x, p, STEPS, BLOCK,
                                                STEPS + 1, 2, launch)
            ms = launch_ms(run, 10)
            if not torch.equal(run(), want):
                raise AssertionError(f"{stencil} {knob} {value}: differs")
            out.append({"stencil": stencil, knob: value,
                        "mode": launch.mode, "ctas": launch.ctas,
                        "threads": (launch.threads + cg.COURIER
                                    if launch.mode == "wave"
                                    else launch.threads * launch.segments),
                        "smem_bytes": launch.smem_bytes,
                        "levels": (-(-(x.shape[0] // BLOCK + 1)
                                     // launch.ctas) * STEPS
                                   if launch.mode == "wave" else
                                   (x.shape[0] // BLOCK + 1) * STEPS),
                        "ms": ms})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ring_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}")
    for row in rows(args.seed):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
