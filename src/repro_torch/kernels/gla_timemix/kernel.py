"""Chunkwise-parallel RWKV-6 / GLA time-mix.

The port of `repro.kernels.gla_timemix.kernel`.  For each (batch, head)
the sequence runs in chunks of ``chunk`` steps with an (hd × hd) float32
state carried from one chunk to the next — the inter-chunk state stream is
the t−1 → t FIFO channel the paper's classifier certifies for this layer;
inside a chunk the work is three (C × hd) products instead of C sequential
steps.  Every intra-chunk decay has an exponent ≤ 0: the factored form
(r·e^{cl_prev})·(k·e^{−cl}) overflows float32 once a chunk's cumulative
decay passes e⁸⁸ (fast channels at chunk ≥ 64).

Only the state depends on earlier chunks, and it is a linear recurrence
over them, S_c = e^{tot_c}·S_{c−1} + D_c.  So both versions run in three
phases: (A) every chunk's increment D_c = (k·e^{tot−cl})ᵀ v and decay
e^{tot_c}; (B) the scan over chunks, giving the state entering each; (C)
every chunk's output from its inputs and that state.  Inside a chunk,
rows come in sub-chunks of `SUB`: within each 8-row half of a diagonal
sub-chunk the decays are formed pairwise, exp(cl_prev[t] − cl[s]);
elsewhere below the diagonal they are factored through a row m between
t and s (the last row of the earlier sub-chunk, or row 7 of the same
one), as exp(cl_prev[t] − cl[m]) · exp(cl[m] − cl[s]), two exponents ≤ 0,
and the block is a product.

`gla_timemix` runs ``csrc/gla_timemix.cu`` on a CUDA tensor and
`_gla_timemix_plain` on a CPU one.  Where a gradient is wanted (grad mode
on and an input requiring one) the call goes through `_GlaTimemix`, a
`torch.autograd.Function`: its forward is the same kernel (or plain
version), its backward recomputes `ref.chunked_timemix` from a zero state
at the same chunk (the reference model's chunked scan, which `jax.grad`
differentiates; the Pallas kernel has no VJP of its own) and returns that
function's gradients for r, k, v, logw and u.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import cuda_lib
from .ref import chunked_timemix

#: dtype → the kernel's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the kernel is built for; others up to the largest are padded
#: with zero channels
_HEAD_DIMS = (16, 32, 64, 128)
#: rows of a sub-chunk (the kernel's tensor-core tile); a chunk is padded
#: with zero rows to a multiple of it
SUB = 16


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


def padded_width(hd: int) -> int:
    """The head width the kernel runs ``hd`` at: the least of `_HEAD_DIMS`
    that holds it.  Zero channels change nothing: r = k = 0 there adds no
    term, v = 0 gives zero output columns, logw = 0 no decay."""
    for width in _HEAD_DIMS:
        if hd <= width:
            return width
    raise RuntimeError(f"gla_timemix: the kernel takes hd up to "
                       f"{_HEAD_DIMS[-1]}, got {hd}")


def workspace_floats(B: int, S: int, H: int, hd: int, chunk: int) -> int:
    """Floats of the kernel's workspace: each chunk's D_c (then the state
    entering it), hd × hd, and its decay e^{tot_c}, hd."""
    return B * H * (S // chunk) * (hd * hd + hd)


def _factored(rc, kc, cl, cl_prev, rows: slice, cols: slice, m: int):
    """att[rows, cols] through row m of cl (every col <= m < every row):
    (r e^{cl_prev − cl[m]}) @ (k e^{cl[m] − cl})ᵀ, both exponents ≤ 0."""
    cm = cl[..., m, None, :]
    qd = rc[..., rows, :] * torch.exp(cl_prev[..., rows, :] - cm)
    kd = kc[..., cols, :] * torch.exp(cm - cl[..., cols, :])
    return qd @ kd.transpose(-1, -2)


def _intra_chunk_att(rc, kc, cl, cl_prev) -> torch.Tensor:
    """att[t, s] = Σ_d r[t,d] k[s,d] exp(cl_prev[t,d] − cl[s,d]) for t > s,
    0 elsewhere, over (…, CP, hd) chunks (CP a multiple of `SUB`), in the
    kernel's order: pairwise inside each 8-row half of a diagonal
    sub-chunk; factored through row 7 for a sub-chunk's lower half against
    its upper half, and through the last row of sub-chunk j for sub-chunk
    i > j."""
    *lead, CP, hd = rc.shape
    half = SUB // 2
    att = rc.new_zeros(*lead, CP, CP)
    ti = torch.arange(half, device=rc.device)
    below = (ti[:, None] > ti[None, :])[..., None]         # (half, half, 1)
    for h0 in range(0, CP, half):
        rh = slice(h0, h0 + half)
        diff = cl_prev[..., rh, None, :] - cl[..., None, rh, :]
        dec = torch.where(below, diff, -torch.inf)
        att[..., rh, rh] = (rc[..., rh, None, :] * kc[..., None, rh, :]
                            * torch.exp(dec)).sum(-1)
    for i in range(CP // SUB):
        i0 = SUB * i
        att[..., i0 + half:i0 + SUB, i0:i0 + half] = _factored(
            rc, kc, cl, cl_prev, slice(i0 + half, i0 + SUB),
            slice(i0, i0 + half), i0 + half - 1)
        for j in range(i):
            att[..., i0:i0 + SUB, SUB * j:SUB * (j + 1)] = _factored(
                rc, kc, cl, cl_prev, slice(i0, i0 + SUB),
                slice(SUB * j, SUB * (j + 1)), SUB * (j + 1) - 1)
    return att


def _gla_timemix_plain(r, k, v, logw, u, *, chunk: int = 64
                       ) -> torch.Tensor:
    """The plain PyTorch version: the kernel's three phases, for all (B, H)
    and chunks at once, on chunks padded with zero rows to a multiple of
    `SUB`."""
    B, S, H, hd = r.shape
    C, NC = chunk, S // chunk
    CP = -(-C // SUB) * SUB

    def chunks(a):                                  # (B, H, NC, CP, hd)
        a = a.float().transpose(1, 2).reshape(B, H, NC, C, hd)
        return F.pad(a, (0, 0, 0, CP - C))

    rc, kc, vc, lw = (chunks(a) for a in (r, k, v, logw))
    cl = torch.cumsum(lw, dim=3)                    # inclusive
    cl_prev = F.pad(cl[..., :-1, :], (0, 0, 1, 0))  # exclusive
    tot = cl[..., -1:, :]                           # (B, H, NC, 1, hd)
    # A: each chunk's state increment and decay
    delta = (kc * torch.exp(tot - cl)).transpose(-1, -2) @ vc
    decay = torch.exp(tot).transpose(-1, -2)        # (B, H, NC, hd, 1)
    # B: the state entering each chunk
    entering = torch.empty_like(delta)
    state = torch.zeros_like(delta[:, :, 0])
    for c in range(NC):
        entering[:, :, c] = state
        state = decay[:, :, c] * state + delta[:, :, c]
    # C: the outputs
    y_inter = (rc * torch.exp(cl_prev)) @ entering
    y_intra = _intra_chunk_att(rc, kc, cl, cl_prev) @ vc
    y_diag = (rc * u.float()[None, :, None, None, :] * kc).sum(
        -1, keepdim=True) * vc
    out = (y_inter + y_intra + y_diag)[..., :C, :].reshape(B, H, S, hd)
    return out.to(r.dtype).transpose(1, 2)


def _gla_timemix_cuda(r, k, v, logw, u, chunk: int) -> torch.Tensor:
    """One call of kernel 6 (its three phases) on CUDA tensors."""
    args = (r, k, v, logw, u)
    if r.dtype not in _DTYPES or any(a.dtype != r.dtype for a in args):
        raise ValueError(f"gla_timemix: the kernel takes one dtype of "
                         f"{sorted(map(str, _DTYPES))} for all inputs, got "
                         f"{[a.dtype for a in args]}")
    if any(a.device != r.device for a in args):
        raise ValueError("gla_timemix: inputs on different devices")
    B, S, H, hd = r.shape
    width = padded_width(hd)
    if width != hd:
        args = tuple(F.pad(a, (0, width - hd)) for a in args)
    r, k, v, logw, u = (cuda_lib.aligned(a) for a in args)
    out = torch.empty_like(r)
    ws = torch.empty(workspace_floats(B, S, H, width, chunk),
                     dtype=torch.float32, device=r.device)
    with cuda_lib.on_device(r.device):
        cuda_lib.GLA_TIMEMIX(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), out.data_ptr(), ws.data_ptr(), B, S, H, width,
            chunk, _DTYPES[r.dtype], 7, cuda_lib.raw_stream(r.device))
    return out if width == hd else out[..., :hd].contiguous()


def _forward(r, k, v, logw, u, chunk: int) -> torch.Tensor:
    if r.device.type == "cpu":
        return _gla_timemix_plain(r, k, v, logw, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"gla_timemix: no kernel for device {r.device}")
    return _gla_timemix_cuda(r, k, v, logw, u, chunk)


def timemix_from_zero(r, k, v, logw, u, chunk: int) -> torch.Tensor:
    """The function kernel 6 computes, as the reference model's chunked
    scan computes it: `ref.chunked_timemix` from a zero state, in r's
    dtype.  Differentiable by PyTorch's autograd."""
    B, S, H, hd = r.shape
    state0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
    y, _ = chunked_timemix(r, k, v, logw.float(), u.float(), state0, chunk)
    return y.to(r.dtype)


class _GlaTimemix(torch.autograd.Function):
    """Kernel 6 (its plain version on the CPU) forward; the backward of
    `timemix_from_zero` on the saved inputs.  The backward runs the
    chunked form's forward again in PyTorch, so a remat'd layer computes
    the time-mix three times: the step's forward, the recompute, and
    this."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, logw, u)
        return _forward(r, k, v, logw, u, chunk)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(n) for a, n in zip(saved, need)]
            out = timemix_from_zero(*ins, ctx.chunk)
            got = iter(torch.autograd.grad(
                out, [a for a in ins if a.requires_grad], grad))
        return (*(next(got) if n else None for n in need), None)


def gla_timemix(r, k, v, logw, u, *, chunk: int = 64) -> torch.Tensor:
    """r/k/v/logw: (B, S, H, hd); u: (H, hd) → (B, S, H, hd) in r's dtype.
    Requires ``S % chunk == 0`` (ValueError otherwise).  Kernel 6,
    ``csrc/gla_timemix.cu``, on CUDA tensors (float32 or bf16, hd up to
    128; RuntimeError where a phase's tiles pass a CTA's shared memory);
    `_gla_timemix_plain` on CPU ones.  With grad mode on and an input
    requiring a gradient, the call is differentiable (`_GlaTimemix`)."""
    _check(r, k, v, logw, u, chunk)
    args = (r, k, v, logw, u)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _GlaTimemix.apply(*args, chunk)
    return _forward(*args, chunk)
