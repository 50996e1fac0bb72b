"""Batched serving launcher: continuous batching over the model's prefill
and decode steps.

The port of `repro.launch.serve`, on one device (the card unless
``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced [--requests 16] [--slots 4] [--max-seq 128] [--max-new 24] \\
        [--seed 0] [--device cuda|cpu]

`serve` is the callable part: it runs the reference launcher's two closures
around a built model and its parameters (a prefill of one prompt into the
admitted slot's cache rows, and a decode step of every slot at the largest
slot position) under `repro_torch.serve`'s batcher.  The reference prefills
the prompt broadcast to every slot, from the whole cache, and keeps the
admitted slot's rows.  In the dense, ssm and encoder-decoder families each
row is computed alone, so a prefill at B = 1 on a view of that slot's rows
gives the same rows and logits, and the port prefills so.  Where the model
has experts (moe, hybrid) the rows are coupled: an expert's capacity counts
the tokens of every row, so which of the slot's tokens an expert drops
depends on the others.  There the port prefills as the reference does: the
prompt broadcast to all B slots on a copy of the cache, the slot's rows
copied back.  A slot's rows lie along each cache leaf's batch axis, where
its plan names ``"batch"`` (dim 2 of the hybrid's Mamba leaves; the
reference's merge assumes dim 1 and fails there).  The encoder-decoder gets
the reference launcher's zero ``frames``, (B, len(prompt), d_model) at
prefill and (B, 1, d_model) at decode.  `main` draws the parameters from
``--seed`` and the requests as the reference launcher draws them, and
prints its line.

Given a DeviceMesh (``serve(…, mesh=)``), the parameters and the cache are
DTensors laid out by the model's `Rules` on that mesh, which for
``decode_32k`` is the reference's serving cell (qwen2-7b's ``""`` entry:
heads, MLP, vocabulary and experts on ``model``, the batch and FSDP on
``data``, the cache's positions on ``model``), and every rank runs the same
batcher in step.  Where a cache leaf's batch axis is sharded, no slot's
rows are one rank's view, so every family prefills as the reference does:
the prompt broadcast to all slots on a copy of the cache, merged back by a
``where`` on each leaf's batch axis.  `main` serves on the reference's mesh
(the production mesh, 1×1 with ``--reduced``) when it is started as ranks
of a job (``WORLD_SIZE`` in the environment, as ``torchrun`` sets it),
joining it as `repro_torch.launch.mesh.init_from_env` does.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import configs
from ..configs.base import reduced as reduce_cfg
from ..models import build
from ..models.common import resolve_device
from ..models.sharding import Rules, is_dtensor, local_tensor
from ..serve import BatchSlots, ContinuousBatcher, Request
from .mesh import device_mesh, init_from_env, make_production_mesh

#: the one device the port runs a model on, as a mesh of axis sizes
MESH = {"data": 1, "model": 1}


def draw_requests(n: int, vocab_size: int, max_new: int, seed: int = 0
                  ) -> List[Request]:
    """The reference launcher's requests: prompts of 4–23 random tokens, each
    asking for 2 to ``max_new`` − 1 new tokens, from ``default_rng(seed)``
    (the reference draws with seed 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n):
        plen = int(rng.integers(4, 24))
        out.append(Request(
            r, rng.integers(0, vocab_size, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(2, max_new))))
    return out


def _whole(x):
    return x.full_tensor() if is_dtensor(x) else x


def serve(model, params, requests: List[Request], slots: int, max_seq: int,
          device=None, mesh=None) -> Tuple[List[Request], Dict[str, float]]:
    """Serve ``requests`` to completion with ``slots`` decode slots and a
    cache of ``max_seq`` positions on ``device`` (the card where None; the
    parameters must be there).  Returns the finished requests and the
    batcher's counters: ``steps`` (decode steps), ``slot_steps`` (occupied
    slots summed over them), ``prefills`` (prefill calls) and ``seconds``
    (host clock of the whole run).  On a DeviceMesh ``mesh`` the parameters
    are laid out on it (see the module docstring)."""
    dev = resolve_device(device)
    rules = Rules.make(MESH if mesh is None else mesh, model.par)
    cfg = model.cfg
    B = slots
    axes = model.batch_axes()
    if rules.on_mesh:
        params = model.distribute(params, rules)
        cache = model.init_cache(B, max_seq, dev, rules)
    else:
        cache = model.init_cache(B, max_seq, dev)
    box = {"cache": cache, "prefills": 0}
    # the prompt goes to every slot where the rows are coupled: by the
    # experts' capacity, or on a mesh that splits a leaf's batch axis
    broadcast = cfg.num_experts > 0 or (rules.on_mesh and any(
        p.is_shard(axes[k]) for k, v in cache.items() for p in v.placements))

    def with_frames(batch, n: int):
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((batch["tokens"].shape[0], n,
                                           cfg.d_model), device=dev)
        names = {"tokens": ("batch", "seq"),
                 "frames": ("batch", "seq", "embed_act")}
        return {k: v if k == "pos" else rules.distribute(v, names[k])
                for k, v in batch.items()}

    def rows(leaf, key, slot):
        if not is_dtensor(leaf):
            return leaf.narrow(axes[key], slot, 1)
        from torch.distributed.tensor import DTensor
        # a DTensor whose batch axis is whole on each rank: a view of the
        # slot's rows in its local block, so writes reach the cache
        view = local_tensor(leaf).narrow(axes[key], slot, 1)
        shape = list(leaf.shape)
        shape[axes[key]] = 1
        return DTensor.from_local(view, leaf.device_mesh, leaf.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=view.stride())

    def merge(leaf, new, key, slot):
        """The slot's rows of ``new`` into ``leaf``, in place."""
        if not is_dtensor(leaf):
            rows(leaf, key, slot).copy_(rows(new, key, slot))
            return
        shape = [1] * leaf.ndim
        shape[axes[key]] = B
        sel = (torch.arange(B, device=dev) == slot).reshape(shape)
        with rules.context():
            leaf.copy_(torch.where(sel, new, leaf))

    def prefill_fn(slot: int, prompt) -> int:
        toks = torch.as_tensor(prompt, dtype=torch.int32, device=dev)[None]
        cache = box["cache"]
        if broadcast:
            # the prompt in every row, from a copy of the whole cache; the
            # slot's rows are copied back
            toks = toks.expand(B, -1)
            work = {k: v.clone() for k, v in cache.items()}
        else:
            # B = 1 on a view of the slot's rows, written in place
            work = {k: rows(v, k, slot) for k, v in cache.items()}
        logits, work = model.prefill_fn(
            params, with_frames({"tokens": toks}, toks.shape[1]), rules, work)
        if broadcast:
            for k, v in cache.items():
                merge(v, work[k], k, slot)
        box["prefills"] += 1
        return int(torch.argmax(_whole(logits)[slot if broadcast else 0, -1]))

    def step_fn(tokens, pos):
        batch = with_frames({"tokens": torch.as_tensor(tokens, device=dev),
                             "pos": int(pos.max())}, 1)
        logits, box["cache"] = model.decode_fn(params, batch, box["cache"],
                                               rules)
        return torch.argmax(_whole(logits)[:, 0], dim=-1).cpu().numpy()

    batcher = ContinuousBatcher(
        BatchSlots(capacity=B, max_seq=max_seq), prefill_fn, step_fn)
    for req in requests:
        batcher.submit(req)
    with torch.no_grad():
        t0 = time.perf_counter()
        done = batcher.run_until_drained()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    return done, {"steps": batcher.steps, "slot_steps": batcher.slot_steps,
                  "prefills": box["prefills"], "seconds": seconds}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.arch_names())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)

    bundle = configs.get(args.arch)
    cfg = reduce_cfg(bundle.model) if args.reduced else bundle.model
    model = build(cfg, bundle.parallel_for("decode_32k", multi_pod=False))
    mesh = None
    if "WORLD_SIZE" in os.environ:          # started as ranks of a job
        sizes = MESH if args.reduced else make_production_mesh()
        init_from_env(sizes, args.device)
        mesh = device_mesh(sizes, args.device)
    params = model.init(args.seed, args.device)
    requests = draw_requests(args.requests, cfg.vocab_size, args.max_new,
                             args.seed)
    done, c = serve(model, params, requests, args.slots, args.max_seq,
                    args.device, mesh)
    total_tokens = sum(len(r.generated) for r in done)
    dt = c["seconds"]
    print(f"served {len(done)} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s, {c['steps']} decode steps, "
          f"avg batch occupancy {c['slot_steps']/max(c['steps'],1):.2f}/"
          f"{args.slots})")


if __name__ == "__main__":
    main()
