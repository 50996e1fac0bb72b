"""Training launcher, on one device (the card unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        [--steps N] [--ckpt DIR] [--reduced] [--lr LR] [--device cuda|cpu]

The port of `repro.launch.train`, with its flags and ``--device``.  Without
``--reduced`` it trains the full config's ``train_4k`` layout on the one
card; ``--reduced`` trains the smoke-sized config with two microbatches and
float32 moments, as the reference does on its CPU container.  The
reference's ``--distributed`` joins a multi-host JAX job; the port runs a
model on one card (sharded execution across cards is not ported: see
`repro_torch.launch.dryrun`), so the flag raises `NotImplementedError`.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import List, Optional

from .. import configs
from ..configs.base import reduced as reduce_cfg
from ..models import build
from ..models.sharding import Rules
from ..train.loop import train

#: the one device the port trains on, as a mesh of axis sizes
MESH = {"data": 1, "model": 1}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.arch_names())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized config (CPU)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--distributed", action="store_true",
                    help="multi-card training (not ported yet)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.distributed:
        raise NotImplementedError(
            "--distributed: the port runs a model on one card; sharded "
            "execution across cards (torch.distributed.tensor over a "
            "multi-card mesh) is the remaining gap of the launch slice, "
            "waiting for a machine with more than one card (ROADMAP.md)")

    bundle = configs.get(args.arch)
    cfg = reduce_cfg(bundle.model) if args.reduced else bundle.model
    par = bundle.parallel_for("train_4k", multi_pod=False)
    if args.reduced:
        par = par.replace(num_microbatches=2, optimizer_state_dtype="float32",
                          grad_accum_dtype="float32")
    model = build(cfg, par)
    rules = Rules.make(MESH, par)
    rep = train(model, rules, steps=args.steps, ckpt_dir=args.ckpt,
                lr=args.lr, device=args.device)
    print(f"steps={rep.steps_run} final_loss={rep.final_loss:.4f} "
          f"preempted={rep.preempted} stragglers={len(rep.stragglers)}")


if __name__ == "__main__":
    main()
