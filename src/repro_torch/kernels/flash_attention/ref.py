"""PyTorch oracle for the flash-attention kernel: the model stack's chunked
online-softmax attention.

`chunked_attention` is a copy of `repro.models.attention.chunked_attention`
(`repro_torch.models.attention` imports it from here, as the CPU path of
train and prefill attention and as cross attention), with the reference's
numerics: q scaled by hd^-½ in the input dtype, scores and the
PV product accumulated in float32, and one bf16 quirk kept — the
probabilities are cast to ``v.dtype`` before the PV product (the Pallas
kernel keeps them in float32; its plain version in `kernel.py` follows the
kernel, this file follows the reference).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * scale`` with the scale rounded to q's dtype first, as JAX
    multiplies an array by a weakly typed Python float.  The scale is a 0-d
    CPU tensor, which a CUDA kernel takes as an argument: a tensor on the
    card would be a copy to it, and PyTorch waits for such a copy."""
    return q * torch.tensor(scale, dtype=q.dtype)


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      q_chunk: int = 2048, kv_chunk: int = 2048,
                      kv_len: Optional[torch.Tensor] = None):
    """Online-softmax attention, O(chunk²) memory.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with KV | H (GQA groups,
    query head h reads kv head h % KV).
    """
    B, Sq, H, hd = q.shape
    _, Skv, KVh, _ = k.shape
    G = H // KVh
    scale = hd ** -0.5
    # GQA grouping h = g·KV + kv
    q = _scaled(q.reshape(B, Sq, G, KVh, hd), scale)

    nq = max(1, Sq // min(q_chunk, Sq))
    cq = Sq // nq
    nk = max(1, Skv // min(kv_chunk, Skv))
    ck = Skv // nk
    qs = q.reshape(B, nq, cq, G, KVh, hd)
    ks = k.reshape(B, nk, ck, KVh, hd)
    vs = v.reshape(B, nk, ck, KVh, hd)

    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev).reshape(nq, cq)
    k_pos = torch.arange(Skv, device=dev).reshape(nk, ck)

    outs = []
    for qi in range(nq):
        qc = qs[:, qi].float()
        m = torch.full((B, cq, G, KVh), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, cq, G, KVh), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, cq, G, KVh, hd), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            kc, vc = ks[:, j], vs[:, j]
            s = torch.einsum("bqghd,bkhd->bqghk", qc, kc.float())
            msk = torch.zeros((cq, ck), dtype=torch.float32, device=dev)
            if causal:
                msk = torch.where(q_pos[qi][:, None] >= k_pos[j][None, :],
                                  0.0, NEG)
            if kv_len is not None:
                msk = msk + torch.where(k_pos[j][None, :] < kv_len, 0.0, NEG)
            s = s + msk[None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * corr + pexp.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqghk,bkhd->bqghd", pexp.to(vc.dtype).float(), vc.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1)                  # (B, nq, cq, G, KV, hd)
    return out.reshape(B, Sq, H, hd).to(v.dtype)


def attention_ref(q, k, v, causal: bool = True):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd), GQA via h % KV."""
    return chunked_attention(q, k, v, causal=causal,
                             q_chunk=q.shape[1], kv_chunk=k.shape[1])
