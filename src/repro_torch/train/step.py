"""The train step: microbatched gradient accumulation + remat + clip +
(8-bit) AdamW, with the layout specs of the reference's production mesh.

The port of `repro.train.step`.  The reference jits the step and scans over
the microbatches; here the step runs eagerly and a Python loop takes the
scan's place.  Each microbatch's gradient comes from `torch.autograd.grad`
of ``Model.loss_fn`` (its layers rematerialized as ``par.remat`` says, and
on the card attention and the RWKV-6 time-mix through kernels 5 and 6,
whose backward is the chunked forms' autograd), is cast to
``grad_accum_dtype`` and summed; the sum is divided by the microbatch count
m, as a device tensor (CUDA PyTorch divides by a Python scalar as a product
with its rounded reciprocal, the CPU and the reference exactly), then
`optim.adamw_update` steps at ``cosine_warmup(lr, warmup, total)(step)``.
The step returns a new state: parameters and moments are new tensors, as
the reference's donated buffers are.

With rules on a DeviceMesh the state is DTensors laid out by
`make_train_state_specs` (`init_train_state(…, rules=)`), the batch is
laid out by ``batch_spec``, and the same step runs on them: each
microbatch's gradient is redistributed to its parameter's layout before it
is summed (a gradient of replicated rows comes back as a partial sum over
the batch's axes), the gradient's global norm is a reduction across the
shards, and AdamW runs on each rank's blocks (`optim.adamw_update`, the
int8 moments in the blocks of the global last dimension).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from ..models.common import plan_map
from ..models.model import Model
from ..models.sharding import Rules
from ..optim import adamw_init, adamw_update, cosine_warmup
from ..optim.quantized import scale_shape
from ..tree import tree_leaves, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _opt_state_spec_like(param_plan, rules: Rules, state_dtype: str):
    """m/v are laid out exactly like their params (int8 q is param-shaped;
    the per-block scale reuses the param's logical names with the
    divisibility fallback handling the shrunken last dim)."""
    def one(p):
        if state_dtype == "int8":
            names = p.names if p.shape else (None,)
            return {"q": rules.spec(p.shape or (1,), names),
                    "scale": rules.spec(scale_shape(p.shape), names)}
        return rules.spec(p.shape, p.names)
    return plan_map(one, param_plan)


def _opt_state_abstract_like(param_plan, state_dtype: str):
    def one(p):
        if state_dtype == "int8":
            return {"q": torch.empty(p.shape or (1,), dtype=torch.int8,
                                     device="meta"),
                    "scale": torch.empty(scale_shape(p.shape),
                                         dtype=torch.float32, device="meta")}
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return plan_map(one, param_plan)


def make_train_state_specs(model: Model, rules: Rules):
    pspecs = model.param_specs(rules)
    sd = model.par.optimizer_state_dtype
    ospec = _opt_state_spec_like(model.plan, rules, sd)
    return {"params": pspecs,
            "opt": {"m": ospec, "v": ospec, "step": ()}}


def make_abstract_train_state(model: Model):
    """The train state's shapes and dtypes as ``meta`` tensors (no
    storage): what a checkpoint restore needs to know of it."""
    sd = model.par.optimizer_state_dtype
    oabs = _opt_state_abstract_like(model.plan, sd)
    return {"params": model.abstract_params(),
            "opt": {"m": oabs, "v": oabs,
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def init_train_state(model: Model, seed: int, device=None,
                     rules: Rules = None):
    """Parameters drawn from ``seed`` and zero moments, on ``device`` (the
    card where None), laid out by `make_train_state_specs` where ``rules``
    are on a DeviceMesh."""
    params = model.init(seed, device)
    if rules is None or not rules.on_mesh:
        return {"params": params,
                "opt": adamw_init(params, model.par.optimizer_state_dtype)}
    # every moment laid out by its spec, as a restore lays it out
    opt = tree_map(rules.distribute_spec,
                   adamw_init(params, model.par.optimizer_state_dtype),
                   make_train_state_specs(model, rules)["opt"])
    return {"params": model.distribute(params, rules), "opt": opt}


def _to_mb(x: torch.Tensor, m: int) -> torch.Tensor:
    """(B, …) → (m, B/m, …) with microbatch i = rows ≡ i (mod m), the
    reference's split (it keeps every microbatch spread over the data
    shards)."""
    B = x.shape[0]
    return x.reshape((B // m, m) + tuple(x.shape[1:])).movedim(1, 0)


def _accumulated_grads(model: Model, rules: Rules, params, batch: Dict
                       ) -> Tuple[Any, torch.Tensor]:
    """The step's gradient and loss: each microbatch's gradient of
    ``loss_fn``'s total, cast to ``grad_accum_dtype`` and summed in
    microbatch order, then divided by m; the mean of the microbatches'
    ``loss`` (not the total) in float32."""
    m = model.par.num_microbatches
    accum = _DTYPES[model.par.grad_accum_dtype]
    leaves = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    wrt = [p for p in tree_leaves(leaves) if p.requires_grad]
    dev = wrt[0].device
    mbs = tree_map(lambda x: _to_mb(x, m), batch)
    g_acc = [torch.zeros_like(p, dtype=accum) for p in wrt]
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(m):
        mb = tree_map(lambda x: x[i], mbs)
        total, met = model.loss_fn(leaves, mb, rules)
        for a, g in zip(g_acc, torch.autograd.grad(total, wrt)):
            if rules.on_mesh:
                g = g.redistribute(a.device_mesh, a.placements)
            a.add_(g.to(accum))
        loss_sum = loss_sum + met["loss"].detach()
    div = torch.full((), float(m), device=dev)
    for a in g_acc:
        a.div_(div.to(a.dtype))
    it = iter(g_acc)
    grads = tree_map(lambda p: next(it) if p.requires_grad else
                     torch.zeros_like(p, dtype=accum), leaves)
    return grads, loss_sum / div


@dataclass
class TrainStepBundle:
    step_fn: Callable            # (state, batch) -> (state, metrics)
    state_specs: Any
    batch_spec: Any
    model: Model
    rules: Rules


def make_train_step(model: Model, rules: Rules, *,
                    lr: float = 3e-4, warmup: int = 100, total: int = 10000
                    ) -> TrainStepBundle:
    par = model.par
    lr_fn = cosine_warmup(lr, warmup, total)

    def train_step(state, batch):
        params = state["params"]
        with rules.context():
            grads, loss = _accumulated_grads(model, rules, params, batch)
            step = state["opt"]["step"]
            with torch.no_grad():
                new_params, new_opt, gnorm = adamw_update(
                    params, grads, state["opt"], lr_fn(step),
                    state_dtype=par.optimizer_state_dtype)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": new_opt["step"]}
        return {"params": new_params, "opt": new_opt}, metrics

    state_specs = make_train_state_specs(model, rules)

    def batch_spec(batch_abstract):
        names = {"tokens": ("batch", "seq"),
                 "frames": ("batch", "seq", "embed_act"), "pos": ()}
        return {k: rules.spec(v.shape, names[k][:len(v.shape)])
                for k, v in batch_abstract.items()}

    return TrainStepBundle(train_step, state_specs, batch_spec, model, rules)
