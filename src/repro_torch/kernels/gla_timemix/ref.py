"""Oracle for the RWKV-6 / gated-linear-attention time-mix core.

The port of `repro.kernels.gla_timemix.ref`.  Per-step recurrence (the
sequential ground truth):

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

r, k, v: (B, S, H, hd); w = exp(logw) ∈ (0,1) per (t, channel); u: (H, hd).
The reference's ``lax.scan`` over S is a Python loop here.

`chunked_timemix` is the reference model's chunkwise-parallel form of the
same recurrence (`repro_torch.models.rwkv` imports it from here): the
function kernel 6's backward differentiates.
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


def chunked_timemix(r, k, v, logw, u, state0, C: int):
    """The reference model's chunkwise-parallel form (`repro.models.rwkv`'s
    chunked scan, which its train step differentiates): (y (B,S,H,hd)
    float32, final state) from r, k, v (any dtype), logw and u in float32,
    a float32 state (B,H,hd,hd) and chunks of C steps, C | S."""
    B, S, H, hd = r.shape
    nc = S // C
    rc = r.reshape(B, nc, C, H, hd).float()
    kc = k.reshape(B, nc, C, H, hd).float()
    vc = v.reshape(B, nc, C, H, hd).float()
    lw = logw.reshape(B, nc, C, H, hd)
    cl = torch.cumsum(lw, dim=2)                                # inclusive
    cl_prev = cl - lw                                           # exclusive
    tot = cl[:, :, -1]                                          # (B,nc,H,hd)
    tri = torch.tril(torch.ones((C, C), dtype=torch.float32,
                                device=r.device), -1)
    below = (tri > 0)[None, :, :, None, None]
    state = state0
    ys = []
    for c in range(nc):
        rc_, kc_, vc_ = rc[:, c], kc[:, c], vc[:, c]            # (B,C,H,hd)
        cl_, clp_, tot_ = cl[:, c], cl_prev[:, c], tot[:, c]
        # inter-chunk: r_t · (decay(≤t-1 from chunk start) * S_prev)
        rdec = rc_ * torch.exp(clp_)
        y_inter = torch.einsum("bthk,bhkd->bthd", rdec, state)
        # intra-chunk decay via pairwise differences (exponent ≤ 0 where
        # unmasked)
        diff = clp_[:, :, None] - cl_[:, None]                   # (B,C,C,H,hd)
        dec = torch.where(below, diff, -torch.inf)
        att = torch.einsum("bthk,bshk,btshk->bhts", rc_, kc_, torch.exp(dec))
        y_intra = torch.einsum("bhts,bshd->bthd", att, vc_)
        # current token bonus
        y_diag = torch.einsum("bthk,bthk->bth", rc_ * u, kc_)[..., None] * vc_
        # state update: S ← exp(tot)·S + Σ_s exp(tot - cl_s) k_s v_sᵀ
        kdec = kc_ * torch.exp(tot_[:, None] - cl_)
        state = torch.exp(tot_)[..., None] * state + torch.einsum(
            "bshk,bshd->bhkd", kdec, vc_)
        ys.append(y_inter + y_intra + y_diag)
    return torch.stack(ys, dim=1).reshape(B, S, H, hd), state
