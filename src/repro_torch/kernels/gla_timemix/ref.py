"""Oracle for the RWKV-6 / gated-linear-attention time-mix core.

The port of `repro.kernels.gla_timemix.ref`.  Per-step recurrence (the
sequential ground truth):

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

r, k, v: (B, S, H, hd); w = exp(logw) ∈ (0,1) per (t, channel); u: (H, hd).
The reference's ``lax.scan`` over S is a Python loop here.
"""
from __future__ import annotations

import torch


def timemix_ref(r, k, v, logw, u):
    B, S, H, hd = r.shape
    r32, k32, v32 = (a.float() for a in (r, k, v))
    w = torch.exp(logw.float())
    u32 = u.float()
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        rt, kt, vt, wt = r32[:, t], k32[:, t], v32[:, t], w[:, t]  # (B,H,hd)
        kv = kt[..., :, None] * vt[..., None, :]               # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkd->bhd", rt,
                               state + u32[None, :, :, None] * kv))
        state = wt[..., None] * state + kv
    return torch.stack(ys, dim=1).to(r.dtype)                  # (B,S,H,hd)
