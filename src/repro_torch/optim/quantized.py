"""Blockwise int8 quantization for optimizer state (8-bit Adam).

m/v are stored as int8 **in the parameter's own shape** with one fp32 scale
per 256-element block of the last dimension, so the quantized state keeps
the parameter's layout and (de)quantization is local elementwise math — no
reshaping of the state into another layout.  About 2 B/param of optimizer
state instead of 8 B.

A DTensor (the sharded train step) is quantized in the blocks of its global
last dimension, as the reference's jitted step computes them whatever the
layout: where that dimension is sharded, a shard need not hold whole
blocks (a last dimension of 300 on two ranks), so the dimension is gathered
first and each rank quantizes its rows whole; ``q`` keeps the value's
placements and ``scale`` those with its last dimension whole.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..tree import tree_map

BLOCK = 256


def scale_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if not shape:
        return (1,)
    last = shape[-1]
    return tuple(shape[:-1]) + (max(1, -(-last // BLOCK)),)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _whole_last(x):
    """A DTensor with its last dimension gathered, and those placements."""
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_shard(x.ndim - 1) else p
               for p in x.placements)
    return x.redistribute(x.device_mesh, pl), pl


def _from_local(t, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def quantize_array(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    if _is_dtensor(x):
        whole, pl = _whole_last(x.to(torch.float32))
        s = quantize_array(whole.to_local())
        mesh = x.device_mesh
        shape = tuple(x.shape) or (1,)
        q = _from_local(s["q"], mesh, pl, shape)
        return {"q": q.redistribute(mesh, x.placements) if x.ndim else q,
                "scale": _from_local(s["scale"], mesh, pl,
                                     scale_shape(tuple(x.shape)))}
    x = x.to(torch.float32)
    if x.ndim == 0:
        x = x[None]
    last = x.shape[-1]
    nb = max(1, -(-last // BLOCK))
    pad = nb * BLOCK - last
    xp = F.pad(x, (0, pad))
    blocks = xp.reshape(*x.shape[:-1], nb, BLOCK)
    # a tensor on x's device, not a Python scalar: CUDA PyTorch divides by a
    # Python scalar by multiplying with its rounded reciprocal, which would
    # move some scales by a unit in the last place from the CPU's
    scale = blocks.abs().amax(-1) / torch.full((), 127.0,     # (..., nb)
                                                device=x.device)
    safe = torch.clamp(scale, min=1e-12)
    q = torch.round(blocks / safe[..., None]).to(torch.int8)
    q = q.reshape(*x.shape[:-1], nb * BLOCK)[..., :last]
    return {"q": q, "scale": scale}


def dequantize_array(s: Dict[str, torch.Tensor], shape,
                     dtype=torch.float32) -> torch.Tensor:
    q, scale = s["q"], s["scale"]
    if _is_dtensor(q):
        whole, pl = _whole_last(q)
        mesh = q.device_mesh
        sc = scale.redistribute(mesh, pl).to_local()
        x = dequantize_array({"q": whole.to_local(), "scale": sc},
                             whole.to_local().shape, dtype)
        return _from_local(x, mesh, pl, q.shape).redistribute(
            mesh, q.placements).reshape(shape)
    view = q if q.ndim else q[None]
    last = view.shape[-1]
    nb = scale.shape[-1]
    pad = nb * BLOCK - last
    qp = F.pad(view.to(torch.float32), (0, pad))
    x = qp.reshape(*view.shape[:-1], nb, BLOCK) * scale[..., None]
    x = x.reshape(*view.shape[:-1], nb * BLOCK)[..., :last]
    return x.reshape(shape).to(dtype)


def quantize_state(tree):
    return tree_map(quantize_array, tree)


def dequantize_state(qtree, like_tree):
    return tree_map(lambda ref, s: dequantize_array(s, ref.shape),
                    like_tree, qtree)
