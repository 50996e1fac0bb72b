"""Mamba (S6) selective state-space block for the hybrid (jamba) family.

The port of `repro.models.ssm`.  Train and prefill run a *blocked* selective
scan: a loop over sequence blocks carries the (B, d_inner, d_state) state,
and inside each block a log-step scan takes the reference's
``associative_scan`` place with its combine, (a, b) ∘ (a', b') = (a·a',
b·a' + b').  The split is the reference's: the smallest divisor of S that
is at least ceil(S / block).  Each block's decay and drive, (B, L_blk,
d_inner, d_state) in float32, are made inside the loop, so no tensor of the
whole sequence's state is held at once (the reference builds them for all
of S, then splits).  Decode is a single recurrent update.

The reference has no Pallas kernel here, so neither does the port: the
block scan is plain PyTorch on every device, and the projections are
`torch.matmul`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import PSpec
from .sharding import Rules


def mamba_plan(cfg: ModelConfig) -> Dict:
    D = cfg.d_model
    di = cfg.ssm_expand * D
    ds = cfg.ssm_state_dim
    w = cfg.ssm_conv_width
    return {
        "in_proj": PSpec((D, 2 * di), ("wfsdp", "wtp"), "normal", 1.0),
        "conv_w": PSpec((w, di), (None, "wtp"), "normal", 1.0),
        "conv_b": PSpec((di,), ("wtp",), "zeros"),
        "bc_proj": PSpec((di, 2 * ds), ("wtp", None), "normal", 1.0),
        "dt_proj": PSpec((di, di), ("wtp", "wtp"), "normal", 1.0),
        "dt_bias": PSpec((di,), ("wtp",), "zeros"),
        "A_log": PSpec((di, ds), ("wtp", None), "zeros"),
        "Dskip": PSpec((di,), ("wtp",), "ones"),
        "out_proj": PSpec((di, D), ("wtp", "wfsdp"), "normal", 1.0),
    }


def _ssm_block_scan(decay, drive, h0):
    """h_t = decay_t · h_{t−1} + drive_t within one block: an inclusive
    log-step (Hillis–Steele) scan of the pairs (decay, drive) under the
    reference's combine, then the carried state h0 entered through the
    cumulative decay.  decay, drive: (B, L, di, ds); h0: (B, di, ds).
    Returns every step's state and the last."""
    a, b = decay, drive
    L = a.shape[1]
    d = 1
    while d < L:
        # element t combines with t − d: (a_{t−d}·a_t, b_{t−d}·a_t + b_t)
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    h = b + a * h0[:, None]
    return h, h[:, -1]


def num_blocks(S: int, block: int = 512) -> int:
    """The reference's split: the smallest divisor of S that is at least
    ceil(S / min(block, S))."""
    nb = max(1, -(-S // min(block, S)))
    while S % nb:
        nb += 1
    return nb


def _common(*ts):
    """The tensors cast to their promoted dtype, as jnp promotes a mixed
    product (a bfloat16 cache against float32 weights)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _matmul(a, b):
    a, b = _common(a, b)
    return a @ b


def apply_mamba(p, x, cfg: ModelConfig, rules: Rules, mode: str,
                cache: Optional[Dict] = None, block: int = 512
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B,S,D) → (y, new_cache).

    cache = {"conv": (B, w-1, di), "ssm": (B, di, ds)}."""
    B, S, D = x.shape
    di = cfg.ssm_expand * D
    ds = cfg.ssm_state_dim
    w = cfg.ssm_conv_width

    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xin = rules.constrain(xin, "batch", "seq", "mlp_act")

    if mode == "decode":
        conv_state = torch.cat([cache["conv"], xin.to(cache["conv"].dtype)],
                               dim=1)                              # (B, w, di)
        cs, cw, cb = _common(conv_state, p["conv_w"], p["conv_b"])
        xc = F.silu(torch.einsum("bwd,wd->bd", cs, cw) + cb)[:, None]
        new_conv = conv_state[:, 1:]
    else:
        prev = (cache["conv"] if cache is not None
                else torch.zeros((B, w - 1, di), dtype=xin.dtype,
                                 device=x.device))
        xpad = torch.cat([prev.to(xin.dtype), xin], dim=1)
        xc = sum(xpad[:, i:i + S] * p["conv_w"][i] for i in range(w)) \
            + p["conv_b"]
        xc = F.silu(xc)
        new_conv = xpad[:, -(w - 1):]

    Bm, Cm = _matmul(xc, p["bc_proj"]).float().chunk(2, dim=-1)   # (B,S,ds)
    dt = F.softplus(_matmul(xc, p["dt_proj"]).float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                             # (di, ds)
    xdt = dt * xc.float()                                          # (B,S,di)

    h0 = (cache["ssm"].float() if cache is not None
          else torch.zeros((B, di, ds), dtype=torch.float32, device=x.device))

    if mode == "decode":
        h = torch.exp(dt[:, 0, :, None] * A) * h0 \
            + xdt[:, 0, :, None] * Bm[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None]
        new_ssm = h
    else:
        Lb = S // num_blocks(S, block)
        h, ys = h0, []
        for s0 in range(0, S, Lb):
            blk = slice(s0, s0 + Lb)
            decay = torch.exp(dt[:, blk, :, None] * A)         # (B,Lb,di,ds)
            drive = xdt[:, blk, :, None] * Bm[:, blk, None, :]
            h_blk, h = _ssm_block_scan(decay, drive, h)
            ys.append(torch.einsum("bsdn,bsn->bsd", h_blk, Cm[:, blk]))
        y = torch.cat(ys, dim=1)
        new_ssm = h

    y = y + xc.float() * p["Dskip"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    y = rules.constrain(y, "batch", "seq", "mlp_act")
    out = y @ p["out_proj"]
    new_cache = None
    if cache is not None or mode != "train":
        new_cache = {"conv": new_conv.to(xin.dtype),
                     "ssm": new_ssm.float()}
    return out, new_cache


def mamba_cache_shapes(cfg: ModelConfig, batch: int):
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": ((batch, cfg.ssm_conv_width - 1, di),
                     ("batch", None, "mlp_act"), "bfloat16"),
            "ssm": ((batch, di, cfg.ssm_state_dim),
                    ("batch", "mlp_act", None), "float32")}
