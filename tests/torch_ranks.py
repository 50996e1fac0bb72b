"""Rank functions the port's tests spawn (`repro_torch.comm.run_ranks`) over
a gloo `DistGroup`.  Importable by name, and free of jax and `repro`, so a
spawned rank starts with torch alone.  Each reads the test's numpy inputs
from an ``.npz`` and writes what its stage computed to ``rank<r>.npz``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm import (DistGroup, PipelineSpec, analyze_pipeline,
                              fifo_shift, pipeline_loss_fn, stage_params)
from repro_torch.optim.compression import compressed_psum_mean

#: the pipeline selections both packages run, by name (the port's names;
#: "cuda:ppermute" is the counterpart of the reference's "pallas:ppermute")
SELECTIONS = ("plans", "reorder-buffer", "cuda:ppermute")


def stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def loss_head(h, tgt):
    return torch.mean((h - tgt) ** 2)


def selection_kwargs(name: str, stages: int, microbatches: int) -> dict:
    if name == "plans":
        _, plans = analyze_pipeline(PipelineSpec(stages=stages,
                                                 microbatches=microbatches))
        return {"plans": plans}
    return {"lowering": name}


def pipeline_grads(group, params_np, xs, tg, **kwargs):
    """The pipeline's loss and its gradients on ``group``'s local block."""
    params = stage_params(params_np, group)
    for p in params.values():
        p.requires_grad_()
    f = pipeline_loss_fn(stage_fn, loss_head, group, **kwargs)
    loss = f(params, xs.to(group.device), tg.to(group.device))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


class AllReduceInBackward(DistGroup):
    """A group whose sum all-reduce also all-reduces in backward
    (``torch.distributed.nn.functional.all_reduce``): the pitfall the
    port's `DistGroup` avoids, kept to show that it multiplies every
    gradient by the number of ranks."""

    def all_reduce(self, x, op="sum"):
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(x, group=self.pg or dist.group.WORLD)


def pipeline_rank(rank: int, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    data = np.load(inputs)
    params_np = {"w": data["w"], "b": data["b"]}
    xs, tg = torch.from_numpy(data["xs"]), torch.from_numpy(data["tg"])
    S, M = data["w"].shape[0], data["xs"].shape[0]
    group = DistGroup()
    out = {}
    for name in SELECTIONS:
        loss, grads = pipeline_grads(group, params_np, xs, tg,
                                     **selection_kwargs(name, S, M))
        out[f"{name}/loss"] = loss.numpy()
        for k, g in grads.items():
            out[f"{name}/grad_{k}"] = g.numpy()
    _, grads = pipeline_grads(AllReduceInBackward(), params_np, xs, tg,
                              lowering="ppermute")
    for k, g in grads.items():
        out[f"all_reduce_in_backward/grad_{k}"] = g.numpy()
    x = torch.full((1, 3), float(rank + 1))
    for k in (1, -1):
        out[f"shift_{k}"] = fifo_shift(x, group, k).numpy()
        out[f"shift_{k}_wrap"] = fifo_shift(x, group, k, wrap=True).numpy()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


def ef_step(w, t, e, group):
    """One step of the reference's error-feedback descent on a distributed
    quadratic (`tests/test_compression.py`)."""
    mean_g, e = compressed_psum_mean(w - t, e, group)
    return w - 0.3 * mean_g, e


def ef_run(w, t, steps: int, group):
    e = torch.zeros_like(w)
    for _ in range(steps):
        w, e = ef_step(w, t, e, group)
    return w, e


def compression_rank(rank: int, inputs: str, reference: str,
                     out_dir: str) -> None:
    """This rank's row of the compressed mean, each error-feedback step
    from the reference's state after the step before, and a whole run."""
    torch.set_num_threads(1)
    data, ref = np.load(inputs), np.load(reference)
    group = DistGroup()
    row = slice(rank, rank + 1)
    g = torch.from_numpy(data["g"][row])
    mean, err = compressed_psum_mean(g, torch.zeros_like(g), group)
    t = torch.from_numpy(data["targets"][row])
    steps = [ef_step(torch.from_numpy(ref["traj_w"][i][row]), t,
                     torch.from_numpy(ref["traj_e"][i][row]), group)
             for i in range(int(data["ef_steps"]))]
    w, _ = ef_run(torch.from_numpy(data["w0"][row]), t,
                  int(data["ef_steps"]), group)
    np.savez(Path(out_dir) / f"rank{rank}.npz", mean=mean.numpy(),
             err=err.numpy(), w=w.numpy(),
             steps_w=np.stack([s[0].numpy() for s in steps], 1),
             steps_e=np.stack([s[1].numpy() for s in steps], 1))


def load_ranks(out_dir, world: int) -> dict:
    """Every rank's arrays, stacked along a new leading stage axis."""
    parts = [np.load(Path(out_dir) / f"rank{r}.npz") for r in range(world)]
    return {k: np.concatenate([p[k] for p in parts]) if parts[0][k].ndim
            else np.stack([p[k] for p in parts]) for k in parts[0].files}


def sleeping_rank(rank: int, seconds: float) -> None:
    import time
    time.sleep(seconds)
