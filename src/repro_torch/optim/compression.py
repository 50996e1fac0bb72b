"""int8 gradient compression with error feedback, for a data-parallel
all-reduce over a stage group (`repro_torch.comm.group`).

Compression applies where the reduction is explicit: a group's all-reduce
(the pipeline runtime's stage group, or ranks of a data-parallel group).

Scheme (standard EF-SGD / 1-bit-Adam family):
    val    = grad + error_feedback              (carry quantization residual)
    scale  = max over the group(max|val|) / 127 (shared scale per tensor)
    q      = round(val / scale)  : int8
    summed = sum over the group(q : int32) · scale / n      (mean)
    error' = val − q·scale                      (local residual, fed back)

Wire cost: 1 byte/element instead of 2 (bf16) or 4 (f32).  Every tensor
carries the group's local block of stages as its leading dimension; the
scale is one per stage's tensor, shared over the group.
"""
from __future__ import annotations

from typing import Tuple

import torch


def compressed_psum_mean(grad: torch.Tensor, error: torch.Tensor, group
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce `grad` over ``group`` in int8; returns
    (mean_grad f32, new_error)."""
    val = grad.to(torch.float32) + error
    b = val.shape[0]
    local_amax = val.abs().reshape(b, -1).amax(1)
    # divide by a tensor, not a Python scalar (see quantized.quantize_array)
    scale = group.all_reduce(local_amax, "max") / val.new_tensor(127.0)
    safe = torch.clamp(scale, min=1e-20).view((b,) + (1,) * (val.ndim - 1))
    q = torch.clamp(torch.round(val / safe), -127, 127).to(torch.int8)
    new_error = val - q.to(torch.float32) * safe
    summed = group.all_reduce(q.to(torch.int32), "sum")
    mean = summed.to(torch.float32) * safe / val.new_tensor(float(group.size))
    return mean, new_error


def compressed_grad_sync(grads, errors, group):
    """Dict version: per-leaf compressed mean all-reduce + error feedback."""
    out = {k: compressed_psum_mean(g, errors[k], group)
           for k, g in grads.items()}
    return ({k: o[0] for k, o in out.items()},
            {k: o[1] for k, o in out.items()})


def init_error_feedback(grads):
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}
