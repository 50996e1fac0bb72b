"""Training launcher, on one device (the card unless ``--device cpu``) or,
with ``--distributed``, on a device mesh a rank a card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        [--steps N] [--ckpt DIR] [--reduced] [--lr LR] [--distributed] \\
        [--device cuda|cpu]

The port of `repro.launch.train`, with its flags and ``--device``.  Without
``--reduced`` it trains the full config's ``train_4k`` layout;
``--reduced`` trains the smoke-sized config with two microbatches and
float32 moments, as the reference does on its CPU container.  Without
``--distributed`` it trains on the one device.  With it, as the reference's
``jax.distributed.initialize``, every rank (one a card, started by a
launcher such as ``torchrun`` that sets ``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``) joins the job from the
environment, NCCL on the card and gloo with ``--device cpu``, and trains on
the reference's mesh as a `DeviceMesh`: the production mesh (16×16)
without ``--reduced``, 1×1 with it.  A world size other than that mesh's
card count is refused with both named.
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
from .mesh import device_mesh, init_from_env, make_production_mesh

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
                    help="join the job the environment names and train on "
                         "the reference's mesh, a rank a card")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    bundle = configs.get(args.arch)
    cfg = reduce_cfg(bundle.model) if args.reduced else bundle.model
    par = bundle.parallel_for("train_4k", multi_pod=False)
    if args.reduced:
        par = par.replace(num_microbatches=2, optimizer_state_dtype="float32",
                          grad_accum_dtype="float32")
    model = build(cfg, par)
    if not args.distributed:
        rep = train(model, Rules.make(MESH, par), steps=args.steps,
                    ckpt_dir=args.ckpt, lr=args.lr, device=args.device)
    else:
        import torch.distributed as dist
        sizes = MESH if args.reduced else make_production_mesh()
        own = not dist.is_initialized()
        try:
            init_from_env(sizes, args.device)
            rules = Rules.make(device_mesh(sizes, args.device), par)
            rep = train(model, rules, steps=args.steps, ckpt_dir=args.ckpt,
                        lr=args.lr, device=args.device)
        finally:
            if own and dist.is_initialized():
                dist.destroy_process_group()
    print(f"steps={rep.steps_run} final_loss={rep.final_loss:.4f} "
          f"preempted={rep.preempted} stragglers={len(rep.stragglers)}")


if __name__ == "__main__":
    main()
