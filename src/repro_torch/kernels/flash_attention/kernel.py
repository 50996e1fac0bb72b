"""Blocked GQA flash attention with an online softmax.

The port of `repro.kernels.flash_attention.kernel`.  q (B,S,H,hd) is
scaled by hd^-½ in its own dtype, then scores, the running max and sum and
the accumulator are float32; query head ``h`` reads kv head ``h % KV``;
kv blocks wholly above the diagonal are skipped; scores above it are
masked to ``NEG``; the output is ``acc / max(l, 1e-30)`` in q's dtype.

`flash_attention` runs ``csrc/flash_attention.cu`` on a CUDA tensor and
`_flash_attention_plain` on a CPU one.  Where a gradient is wanted (grad
mode on and q, k or v requiring one) the call goes through
`_FlashAttention`, a `torch.autograd.Function`: its forward is the same
kernel (or plain version), its backward recomputes `ref.chunked_attention`
(the reference's train-mode attention, which `jax.grad` differentiates;
the Pallas kernel has no VJP of its own) on the saved q, k and v and
returns that function's gradients.  The plain version walks the
reference kernel's grid in ``bq × bk`` blocks and keeps the probabilities
in float32, as the Pallas kernel does.  The CUDA kernel rounds them to
bf16 or f16 for its tensor-core product on those inputs, as
`ref.chunked_attention` (the reference's oracle) casts them to
``v.dtype``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib
from .ref import NEG, _scaled, chunked_attention

#: dtype → the kernel's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: head widths the kernel is instantiated for; a narrower head is padded
#: with zero channels to the next of them
_HEAD_DIMS = (32, 64, 128)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,S,H,hd) and k, v "
                         f"(B,S,KV,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, hd) or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (need KV | H)")


def padded_width(hd: int) -> int:
    """The head width the kernel runs ``hd`` at: the least of `_HEAD_DIMS`
    that holds it.  Zero channels in q and k add nothing to any score, and
    zero channels in v give output columns that are sliced away; the scale
    stays the true hd's.  ValueError past the widest."""
    for width in _HEAD_DIMS:
        if hd <= width:
            return width
    raise ValueError(f"flash_attention: the kernel takes hd up to "
                     f"{_HEAD_DIMS[-1]}, got {hd}")


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two float32 blocks.  On the CPU it is taken in float64
    and rounded to float32: MKL's batched sgemm (``SGEMM_BATCH``, with its
    run-time choice of threads and no reproducibility mode) once gave one
    (b, h) entry 6e-5 off, and a float64 product is exact enough that no
    choice of kernel or threads shows in the result."""
    if a.device.type == "cpu":
        return (a.double() @ b.double()).float()
    return a @ b


def _flash_attention_plain(q, k, v, *, causal: bool = True, bq: int = 128,
                           bk: int = 128, scale=None) -> torch.Tensor:
    """The plain PyTorch version: the reference kernel's (q block, kv block)
    grid, with (m, l, acc) carried across the kv blocks, for all (B, H) at
    once.  Its two products go through `_product`.  Requires ``S % bq ==
    S % bk == 0`` (ValueError otherwise)."""
    B, S, H, hd = q.shape
    if S % bq or S % bk:
        raise ValueError(f"S = {S} must be a multiple of bq = {bq} and "
                         f"bk = {bk}")
    KV = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    heads = torch.arange(H, device=q.device) % KV
    qt = _scaled(q, scale).transpose(1, 2).float()        # (B, H, S, hd)
    kt = k.transpose(1, 2)[:, heads].float()              # (B, H, S, hd)
    vt = v.transpose(1, 2)[:, heads].float()
    out = torch.empty((B, H, S, hd), dtype=torch.float32, device=q.device)
    for qi in range(S // bq):
        qb = qt[:, :, qi * bq:(qi + 1) * bq]
        m = torch.full((B, H, bq, 1), NEG, device=q.device)
        l = torch.zeros((B, H, bq, 1), device=q.device)
        acc = torch.zeros((B, H, bq, hd), device=q.device)
        for kj in range(S // bk):
            if causal and kj * bk > qi * bq + bq - 1:
                continue                      # wholly above the diagonal
            s = _product(qb, kt[:, :, kj * bk:(kj + 1) * bk]
                         .transpose(-1, -2))
            if causal:
                qpos = qi * bq + torch.arange(bq, device=q.device)[:, None]
                kpos = kj * bk + torch.arange(bk, device=q.device)[None, :]
                s = torch.where(qpos >= kpos, s, NEG)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + _product(p, vt[:, :, kj * bk:(kj + 1) * bk])
            m = m_new
        out[:, :, qi * bq:(qi + 1) * bq] = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype).transpose(1, 2)


def _flash_attention_cuda(q, k, v, causal: bool, scale) -> torch.Tensor:
    """One launch of kernel 5 on CUDA tensors (see `flash_attention`)."""
    B, S, H, hd = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: the kernel takes one of "
                         f"{sorted(map(str, _DTYPES))} for q, k and v, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    width = padded_width(hd)
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    scale = hd ** -0.5 if scale is None else scale
    scale = float(torch.tensor(scale, dtype=q.dtype))     # as JAX rounds it
    if width != hd:
        q, k, v = (torch.nn.functional.pad(a, (0, width - hd))
                   for a in (q, k, v))
    q, k, v = (cuda_lib.aligned(a) for a in (q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        cuda_lib.FLASH_ATTENTION(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, k.shape[2], width, int(causal), scale, _DTYPES[q.dtype],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    return out if width == hd else out[..., :hd].contiguous()


def _forward(q, k, v, causal: bool, bq: int, bk: int, scale):
    if q.device.type == "cpu":
        return _flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _flash_attention_cuda(q, k, v, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """Kernel 5 (its plain version on the CPU) forward; the backward of
    `chunked_attention` on the saved q, k and v.  The backward runs the
    chunked form's forward again in PyTorch, so a remat'd layer computes
    attention three times: the step's forward, the recompute, and this."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bq, bk):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal, bq, bk, None)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(n) for a, n in zip((q, k, v),
                                                               need)]
            out = chunked_attention(*ins, causal=ctx.causal)
            got = iter(torch.autograd.grad(
                out, [a for a in ins if a.requires_grad], grad))
        return (*(next(got) if n else None for n in need), None, None,
                None)


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 128,
                    bk: int = 128, scale=None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) → (B, S, H, hd) in q's dtype.
    Kernel 5, ``csrc/flash_attention.cu``, on CUDA tensors (float32, bf16
    or f16, hd up to 128, run at 32, 64 or 128 with zero channels; its own
    q and kv tiles are 128 rows and take any S, so ``bq`` and ``bk`` do
    not reach it); `_flash_attention_plain` on CPU ones, which requires
    ``S % bq == S % bk == 0``.  With grad mode on and an input requiring a
    gradient, the call is differentiable (`_FlashAttention`) at the
    default scale hd^-½ (ValueError at another)."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        if scale is not None:
            raise ValueError("flash_attention: the gradient is that of "
                             "chunked_attention, which scales by hd^-1/2; "
                             "pass scale=None")
        return _FlashAttention.apply(q, k, v, causal, bq, bk)
    return _forward(q, k, v, causal, bq, bk, scale)
