"""Chunkwise-parallel RWKV-6 / GLA time-mix.

The port of `repro.kernels.gla_timemix.kernel`.  For each (batch, head)
the sequence runs in chunks of ``chunk`` steps with an (hd × hd) float32
state carried from one chunk to the next — the inter-chunk state stream is
the t−1 → t FIFO channel the paper's classifier certifies for this layer;
inside a chunk the work is three (C × hd) products instead of C sequential
steps.  The intra-chunk decays are formed PAIRWISE, exp(cl_prev[t] −
cl[s]) for t > s, whose exponents are ≤ 0: the factored form
(r·e^{cl_prev})·(k·e^{−cl}) overflows float32 once a chunk's cumulative
decay passes e⁸⁸ (fast channels at chunk ≥ 64).

`gla_timemix` runs ``csrc/gla_timemix.cu`` on a CUDA tensor and
`_gla_timemix_plain` on a CPU one.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib

#: dtype → the kernel's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(r, k, v, logw, u, chunk: int) -> None:
    if r.dim() != 4 or any(a.shape != r.shape for a in (k, v, logw)):
        shapes = [tuple(a.shape) for a in (r, k, v, logw)]
        raise ValueError(f"gla_timemix takes r, k, v, logw of one shape "
                         f"(B,S,H,hd), got {shapes}")
    B, S, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u must be (H, hd) = {(H, hd)}, got "
                         f"{tuple(u.shape)}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"S = {S} must be a multiple of chunk = {chunk}")


def _gla_timemix_plain(r, k, v, logw, u, *, chunk: int = 64
                       ) -> torch.Tensor:
    """The plain PyTorch version: the reference kernel's chunk loop, for all
    (B, H) at once."""
    B, S, H, hd = r.shape
    C = chunk
    tr = lambda a: a.float().transpose(1, 2)               # (B, H, S, hd)
    r32, k32, v32, lw32 = tr(r), tr(k), tr(v), tr(logw)
    u32 = u.float()[None, :, None, :]                      # (1, H, 1, hd)
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    out = torch.empty((B, H, S, hd), dtype=torch.float32, device=r.device)
    ti = torch.arange(C, device=r.device)
    below = (ti[:, None] > ti[None, :])[..., None]         # (C, C, 1): t > s
    for c0 in range(0, S, C):
        rc, kc, vc, lw = (a[:, :, c0:c0 + C] for a in (r32, k32, v32, lw32))
        cl = torch.cumsum(lw, dim=2)                       # inclusive
        cl_prev = cl - lw                                  # exclusive
        tot = cl[:, :, -1:]                                # (B, H, 1, hd)
        y_inter = (rc * torch.exp(cl_prev)) @ state
        diff = cl_prev[:, :, :, None, :] - cl[:, :, None, :, :]
        dec = torch.where(below, diff, -torch.inf)         # (B,H,C,C,hd)
        att = (rc[:, :, :, None, :] * kc[:, :, None, :, :]
               * torch.exp(dec)).sum(-1)
        y_intra = att @ vc
        y_diag = (rc * u32 * kc).sum(-1, keepdim=True) * vc
        out[:, :, c0:c0 + C] = y_inter + y_intra + y_diag
        kdec = kc * torch.exp(tot - cl)
        state = torch.exp(tot).transpose(-1, -2) * state + kdec.transpose(
            -1, -2) @ vc
    return out.to(r.dtype).transpose(1, 2)


def gla_timemix(r, k, v, logw, u, *, chunk: int = 64) -> torch.Tensor:
    """r/k/v/logw: (B, S, H, hd); u: (H, hd) → (B, S, H, hd) in r's dtype.
    Requires ``S % chunk == 0`` (ValueError otherwise).  Kernel 6,
    ``csrc/gla_timemix.cu``, on CUDA tensors (float32 or bf16);
    `_gla_timemix_plain` on CPU ones."""
    _check(r, k, v, logw, u, chunk)
    if r.device.type == "cpu":
        return _gla_timemix_plain(r, k, v, logw, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"gla_timemix: no kernel for device {r.device}")
    args = (r, k, v, logw, u)
    if r.dtype not in _DTYPES or any(a.dtype != r.dtype for a in args):
        raise ValueError(f"gla_timemix: the kernel takes one dtype of "
                         f"{sorted(map(str, _DTYPES))} for all inputs, got "
                         f"{[a.dtype for a in args]}")
    if any(a.device != r.device for a in args):
        raise ValueError("gla_timemix: inputs on different devices")
    B, S, H, hd = r.shape
    r, k, v, logw, u = (a.contiguous() for a in args)
    out = torch.empty_like(r)
    with torch.cuda.device(r.device):
        cuda_lib.GLA_TIMEMIX(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), out.data_ptr(), B, S, H, hd, chunk,
            _DTYPES[r.dtype],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    return out
