"""Pipeline parallelism with registry-selected channel lowerings.

GPipe-style schedule over a stage group (`comm.group`, the counterpart of
the reference's ``pipe`` mesh axis inside ``shard_map``): stage parameters
are split over the group; microbatches stream through a rotating
communication step whose implementation comes from the ``"torch"`` backend
of the lowering registry (`repro_torch.runtime.lowering`).  The step is
selected from `ChannelPlan` records — pass the planner's output
(`analyze_pipeline(spec)`) via ``plans=`` and the ring runs the cheapest
lowering that serves every planned channel; ``lowering=`` forces one by
name, optionally backend-qualified (``"cuda:ppermute"``).  Gradients flow
through the transposed collectives under autograd.

The group decides where the stages run: a `LocalGroup` holds all of them in
one process on one device (the card unless told otherwise), a `DistGroup`
one per `torch.distributed` rank.  `stage_params` carries the reference's
stacked parameters (leading dimension = stages) into a group's local block.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ..runtime.lowering import (FIFO_STREAM, REORDER_BUFFER, backend,
                                is_cheap)
from ..tree import tree_leaves, tree_map


def ring_lowering(plans: Iterable) -> str:
    """The single lowering a rotating ring needs to serve every planned
    channel: the cheap ppermute stream iff every `ChannelPlan` record is a
    stream (recovered splits included), else the reorder-buffer fallback.
    Accepts plan objects or their `as_dict()` form."""
    names = [p["lowering"] if isinstance(p, dict) else p.lowering
             for p in plans]
    return (FIFO_STREAM if all(is_cheap(n) for n in names)
            else REORDER_BUFFER)


def _split_backend(lowering: str) -> Tuple[str, str]:
    """Parse an optionally backend-qualified lowering name: ``"ppermute"``
    is served by the default ``"torch"`` backend, ``"cuda:ppermute"`` by the
    cuda backend's lowerings.  Plan records stay unqualified; the registry
    decides."""
    if ":" in lowering:
        bname, lname = lowering.split(":", 1)
        return bname, lname
    return "torch", lowering


def _resolve_lowering(lowering: Optional[str], plans) -> str:
    # plan records first, then an explicit registry name, then the stream
    if plans is not None:
        return ring_lowering(plans)
    return FIFO_STREAM if lowering is None else lowering


def _ring_step(lowering: str) -> Callable:
    """The registry's per-tick step for a (qualified) lowering name; raises
    before the first tick when that backend's lowering has none."""
    bname, lname = _split_backend(lowering)
    impl = backend(bname).implementation(lname)
    step = getattr(impl, "step", None)
    if not callable(step):
        raise ValueError(f"backend {bname!r} has no pipeline step for "
                         f"lowering {lname!r} ({impl.describe()}); the ring "
                         f"runs on the 'torch' and 'cuda' backends")
    return step


def stage_params(tree, group):
    """The group's local block of stacked stage parameters: ``tree`` is a
    (nested) dict of arrays whose leading dimension is the number of stages,
    as the reference's ``params_stacked``; each leaf becomes a tensor on
    ``group.device`` holding the rows of ``group.stages``."""
    idx = group.stages.cpu().numpy()

    def local(a):
        a = np.asarray(a)
        if a.shape[:1] != (group.size,):
            raise ValueError(f"stacked parameter of shape {a.shape} has no "
                             f"leading dimension of {group.size} stages")
        return torch.from_numpy(np.ascontiguousarray(a[idx])).to(group.device)

    return tree_map(local, tree)


def pipeline_loss_fn(stage_fn: Callable, loss_head: Callable, group,
                     lowering: Optional[str] = None, *, plans=None):
    """Build loss(params_local, xs, targets) running the stage pipeline.

    stage_fn(stage_params, h) -> h           (one stage's computation)
    loss_head(h, target_mb) -> scalar        (applied at the last stage)
    params_local: (nested) dict of tensors, leading dim = the group's local
    block of stages (`stage_params`); xs: (M, mb, …) microbatched inputs;
    targets: (M, …) per microbatch; both on ``group.device``, the same on
    every rank.

    The inter-stage channel implementation is selected through the lowering
    registry: from ``plans`` (`ChannelPlan` records, preferred) or an
    explicit ``lowering`` name, optionally backend-qualified
    (``"cuda:ppermute"``); neither runs the ppermute stream.  The loss is
    the mean over microbatches, the same scalar on every stage.
    """
    n = group.size
    step = _ring_step(_resolve_lowering(lowering, plans))
    stage = group.stages
    run_stages = torch.func.vmap(stage_fn)
    heads = torch.func.vmap(loss_head, in_dims=(0, None))

    def loss(params, xs, targets):
        M = xs.shape[0]
        T = M + n - 1                        # pipeline ticks
        b = stage.shape[0]
        first = (stage == 0).view((b,) + (1,) * (xs.ndim - 1))
        last = (stage == n - 1).to(torch.float32)
        h = xs.new_zeros((b,) + xs.shape[1:])
        loss_acc = torch.zeros(b, dtype=torch.float32, device=xs.device)
        for t in range(T):
            # first stage injects microbatch t (if any left)
            h_in = torch.where(first, xs[min(t, M - 1)], h)
            h_out = run_stages(params, h_in)
            # last stage consumes microbatch t-(n-1)
            out_id = t - (n - 1)
            mb_loss = heads(h_out, targets[min(max(out_id, 0), M - 1)])
            take = last * float(0 <= out_id < M)
            loss_acc = loss_acc + take.to(mb_loss.dtype) * mb_loss
            # stage s → s+1 channel: one registry-selected lowering step
            h = step(h_out, group, stage, n)
        # every stage holds the (replicated) total loss
        return group.all_reduce(loss_acc)[0] / M

    return loss


def pipeline_train_step(stage_fn, loss_head, group,
                        lowering: Optional[str] = None, lr: float = 1e-2,
                        *, plans=None):
    """SGD step on the pipelined loss (used by examples/tests):
    ``step(params_local, xs, targets) -> (new_params_local, loss)``."""
    loss_fn = pipeline_loss_fn(stage_fn, loss_head, group, lowering,
                               plans=plans)

    def step(params, xs, targets):
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(params, xs, targets)
        grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
        with torch.no_grad():
            new = tree_map(lambda p: p - lr * next(grads), params)
        return new, loss.detach()

    return step
