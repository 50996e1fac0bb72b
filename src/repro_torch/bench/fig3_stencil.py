"""Fig. 3 on the card: the FIFO-streamed jacobi-1d, hand-written AND
generated, against the oracle, with CUDA-event times and the device-memory
traffic model that is the kernel's roofline claim (T·2N → 2N bytes).

The counterpart of `benchmarks/fig3_stencil.py`.  The hand-written rows run
`jacobi_fifo_op` (kernel 4, ``csrc/stencil_fifo.cu``); the generated rows
run ``analyze(jacobi-1d)...plan().compile(backend="cuda")`` (kernel 1, the
fused ring) at the same tiling.  Both need a CUDA device: without one the
benchmark exits 2 and prints no row.

    PYTHONPATH=src python -m repro_torch.bench.fig3_stencil [--seed N]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch

from . import cuda_ms

#: (N, T) of the reference benchmark's rows; block = steps = T
SHAPES = ((1024, 128), (4096, 256))


def rows(seed: int = 0) -> List[Dict[str, object]]:
    """One hand-written and one generated row for each of `SHAPES`, on the
    current CUDA device.  ``err`` is the max abs error against the PyTorch
    oracle (whose largest magnitude is ``oracle_max_abs``);
    ``vs_handwritten_err`` the max abs difference of the two kernels'
    outputs; ``waves`` the hand-written kernel's chain of levels."""
    if not torch.cuda.is_available():
        raise RuntimeError("fig3_stencil times kernels on a CUDA device; "
                           "there is none")
    import repro_torch.core.polybench  # noqa: F401  (populate the registry)
    from repro_torch.core import analyze
    from repro_torch.core.registry import get
    from repro_torch.kernels.stencil_fifo import (hbm_traffic_model,
                                                  jacobi_fifo_op,
                                                  jacobi_naive_op)
    from repro_torch.kernels.stencil_fifo.kernel import fifo_launch

    gen = (analyze(get("jacobi-1d")).classify().fifoize().size().plan()
           .compile(backend="cuda"))
    rng = np.random.default_rng(seed)
    out = []
    for n, bn in SHAPES:
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                             ).to("cuda")
        want = jacobi_naive_op(x, bn)
        m = hbm_traffic_model(n, bn)
        common = {"n": n, "steps": bn,
                  "oracle_max_abs": float(want.abs().max())}
        hand = jacobi_fifo_op(x, bn, bn)
        ms = cuda_ms(lambda: jacobi_fifo_op(x, bn, bn))
        generated = gen(x, bn, bn)
        ms_g = cuda_ms(lambda: gen(x, bn, bn))
        out.append({
            "name": f"fig3/stencil_n{n}_T{bn}", "ms": ms,
            "err": float((hand - want).abs().max()), **common,
            "naive_bytes": m["naive_bytes"], "fifo_bytes": m["fifo_bytes"],
            "reduction": m["reduction"], "waves": fifo_launch(n, bn).waves})
        out.append({
            "name": f"fig3/generated_n{n}_T{bn}", "ms": ms_g,
            "err": float((generated - want).abs().max()), **common,
            "vs_handwritten": ms / ms_g,
            "vs_handwritten_err": float((generated - hand).abs().max())})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fig3_stencil: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}")
    print("name,ms,derived")
    for row in rows(args.seed):
        if "reduction" in row:
            derived = (f"err={row['err']:.1e} waves={row['waves']} traffic "
                       f"{row['naive_bytes']:.2e}B -> {row['fifo_bytes']:.2e}B"
                       f" ({row['reduction']:.0f}x)")
        else:
            derived = (f"err={row['err']:.1e} vs handwritten "
                       f"{row['vs_handwritten']:.2f}x (outputs differ by "
                       f"{row['vs_handwritten_err']:.1e})")
        print(f"{row['name']},{row['ms']:.4f},{derived}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
