"""AdamW with optionally blockwise-int8 moment state (optim.quantized).

The update is elementwise over each parameter, so it keeps whatever layout
or placement the parameter has (a stage group's local block of a stacked
parameter included).  Parameters, gradients and moments are (nested) dicts
of tensors with the same keys.
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map
from .quantized import dequantize_array, quantize_array


def global_norm(tree) -> torch.Tensor:
    def sumsq(x):
        if x.ndim >= 2 and x.shape[0] > 1 and x.numel() >= (1 << 24):
            # slice-wise, as the reference's lax.map: the sum of each slice
            # of the leading dimension, then of those; the slices taken in
            # groups of up to 2**24 elements, so no full f32 convert of a
            # large gradient is made and a long leading dimension (an
            # embedding's vocabulary) costs a few launches, not two a slice
            per = max(1, (1 << 24) // (x.numel() // x.shape[0]))
            dims = tuple(range(1, x.ndim))
            return torch.cat([torch.square(c.to(torch.float32)).sum(dims)
                              for c in x.split(per)]).sum()
        return torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(sum(sumsq(x) for x in tree_leaves(tree)))


def adamw_init(params, state_dtype: str = "float32"):
    def zeros_like_state(p):
        zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return quantize_array(zeros) if state_dtype == "int8" else zeros
    return {"m": tree_map(zeros_like_state, params),
            "v": tree_map(zeros_like_state, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def adamw_update(params, grads, opt, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0, state_dtype="float32",
                 chunk_threshold=1 << 60):
    """One AdamW step with global-norm clipping: returns
    ``(new_params, new_opt, gnorm)``.  A parameter of at least
    ``chunk_threshold`` elements with a leading (stacked-layer) dimension is
    updated in slices of that dimension, with the same result and at most
    one slice's float32 transients at a time."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    # a tensor numerator: a Python one divides as reciprocal × scalar
    scale = torch.clamp(torch.full_like(gnorm, clip_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    step_f = step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m_f = dequantize_array(m, p.shape) if state_dtype == "int8" else m
        v_f = dequantize_array(v, p.shape) if state_dtype == "int8" else v
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * torch.square(g)
        mhat = m_f / (1 - b1 ** step_f)
        vhat = v_f / (1 - b2 ** step_f)
        delta = (mhat / (torch.sqrt(vhat) + eps)
                 + weight_decay * p.to(torch.float32))
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if state_dtype == "int8":
            return new_p, quantize_array(m_f), quantize_array(v_f)
        return new_p, m_f, v_f

    def upd_maybe_chunked(p, g, m, v):
        if p.ndim >= 2 and p.shape[0] > 1 and p.numel() >= chunk_threshold:
            pieces = min(8, p.shape[0])
            step_n = p.shape[0] // pieces
            outs = []
            for i in range(0, p.shape[0], step_n):
                sl = slice(i, i + step_n)
                outs.append(upd(p[sl], g[sl],
                                tree_map(lambda a: a[sl], m),
                                tree_map(lambda a: a[sl], v)))
            return tuple(tree_map(lambda *xs: torch.cat(xs),
                                  *[o[j] for o in outs]) for j in range(3))
        return upd(p, g, m, v)

    out = tree_map(upd_maybe_chunked, params, grads, opt["m"], opt["v"])
    new_params, new_m, new_v = (tree_map(lambda o: o[j], out)
                                for j in range(3))
    return new_params, {"m": new_m, "v": new_v, "step": step}, gnorm
