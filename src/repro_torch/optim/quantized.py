"""Blockwise int8 quantization for optimizer state (8-bit Adam).

m/v are stored as int8 **in the parameter's own shape** with one fp32 scale
per 256-element block of the last dimension, so the quantized state keeps
the parameter's layout and (de)quantization is local elementwise math — no
reshaping of the state into another layout.  About 2 B/param of optimizer
state instead of 8 B.
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


def quantize_array(x: torch.Tensor) -> Dict[str, torch.Tensor]:
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
