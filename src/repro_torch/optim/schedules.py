"""Learning-rate schedules."""
from __future__ import annotations

import math

import torch


def cosine_warmup(base_lr: float, warmup: int, total: int, min_ratio=0.1):
    """``lr(step)``: linear warm-up over ``warmup`` steps, then a cosine
    decay to ``min_ratio · base_lr`` at ``total``; a float32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        # divisors as tensors on step's device, not Python scalars (see
        # quantized.quantize_array), so the card rounds as the CPU does;
        # filled there, not copied (PyTorch waits for a copy to the card)
        warm = base_lr * torch.clamp(
            (step + 1) / torch.full_like(step, max(warmup, 1)), max=1.0)
        frac = torch.clamp(
            (step - warmup) / torch.full_like(step, max(total - warmup, 1)),
            0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr
