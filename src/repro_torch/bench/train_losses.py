"""Loss trajectories of `train()` at full width on the card: how far the
loss moves in a short run, against the noise of its batches.

    PYTHONPATH=src python -m repro_torch.bench.train_losses \\
        [--arch smollm-135m] [--steps 20] [--lrs 3e-4,1e-3,3e-3] [--seeds 0,1]

For each seed and learning rate, `train()` runs ``--steps`` steps of its
8 x 128 synthetic batches from a fresh checkpoint directory (under
``build/``) with the arch's ``train_4k`` layout, and one line prints the
mean of the last 5 losses minus the mean of the first 5, the losses, and
the card's name and power limit.  One seed gives every learning rate the
same batches and the same init, so lines of one seed differ by the
learning rate alone.
"""
from __future__ import annotations

import argparse
import shutil
import statistics
import subprocess
from pathlib import Path
from typing import List, Optional

BUILD = Path(__file__).resolve().parents[3] / "build" / "train_losses"


def main(argv: Optional[List[str]] = None) -> None:
    import torch

    from .. import configs
    from ..launch.train import MESH
    from ..models import Rules, build
    from ..train.loop import train

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lrs", default="3e-4,1e-3,3e-3")
    ap.add_argument("--seeds", default="0,1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_losses: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    bundle = configs.get(args.arch)
    par = bundle.parallel_for("train_4k", multi_pod=False)
    model = build(bundle.model, par)
    rules = Rules.make(MESH, par)
    for seed in (int(x) for x in args.seeds.split(",")):
        for lr in (float(x) for x in args.lrs.split(",")):
            shutil.rmtree(BUILD, ignore_errors=True)
            rep = train(model, rules, steps=args.steps, ckpt_dir=str(BUILD),
                        seed=seed, ckpt_every=10 ** 9, lr=lr)
            shift = (statistics.mean(rep.losses[-5:])
                     - statistics.mean(rep.losses[:5]))
            print(f"{args.arch} seed {seed} lr {lr:g}: last 5 - first 5 "
                  f"{shift:+.5f}; losses "
                  + " ".join(f"{x:.4f}" for x in rep.losses)
                  + f"; {smi}", flush=True)
    shutil.rmtree(BUILD, ignore_errors=True)


if __name__ == "__main__":
    main()
