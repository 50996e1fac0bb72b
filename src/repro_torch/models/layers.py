"""Shared layers: norms, MLPs, embeddings, rotary embeddings.

The port of `repro.models.layers`, with the reference's numerics: norms in
float32, products in the activations' dtype, and a Python scalar that
multiplies a low-precision tensor rounded to its dtype first, as JAX rounds a
weakly typed scalar (`scaled`).

On a DeviceMesh the layers run on DTensors (`Rules.on_mesh`).  The
embedding gather is the one part written per rank (`_embed_on_mesh`): each
rank looks its tokens up in its block of the vocabulary, rows outside it
read zero, and the blocks' rows are summed over the vocabulary's axes.
The logits stay sharded on the vocabulary (``"vocab_act"``), so the loss's
max and log-sum-exp reduce across the model axis.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import PSpec, bias, linear, norm_scale
from .sharding import Rules, global_offset, is_dtensor


def scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x * scale`` with the scale rounded to x's dtype first, as JAX
    multiplies an array by a weakly typed Python float.  The scale is
    filled on x's device (no copy from the host, so a CUDA graph may
    capture it)."""
    return x * torch.full((), scale, dtype=x.dtype, device=x.device)


# ------------------------------------------------------------------- norms

def norm_plan(cfg: ModelConfig, d: Optional[int] = None) -> Dict:
    d = d or cfg.d_model
    p = {"scale": norm_scale(d)}
    if cfg.norm == "layernorm":
        p["bias"] = bias(d)
    return p


def apply_norm(p, x, cfg: ModelConfig):
    x32 = x.float()
    if cfg.norm == "layernorm":
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + 1e-5)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


def rms_head(x, scale, eps=1e-6):
    """qk-norm: per-head RMS norm."""
    x32 = x.float()
    ms = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# -------------------------------------------------------------------- MLP

def mlp_plan(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":           # SwiGLU
        return {"wi_gate": linear(D, F_, names=("wfsdp", "wtp")),
                "wi_up": linear(D, F_, names=("wfsdp", "wtp")),
                "wo": linear(F_, D, names=("wtp", "wfsdp"))}
    return {"wi": linear(D, F_, names=("wfsdp", "wtp")),
            "wo": linear(F_, D, names=("wtp", "wfsdp"))}


def apply_mlp(p, x, cfg: ModelConfig, rules: Rules):
    if cfg.act == "silu":
        g = x @ p["wi_gate"]
        u = x @ p["wi_up"]
        h = F.silu(g) * u
    else:
        h = x @ p["wi"]
        # jax.nn.gelu is the tanh approximation
        h = (F.gelu(h, approximate="tanh") if cfg.act == "gelu"
             else torch.square(F.relu(h)))
    h = rules.constrain(h, "batch", "seq", "mlp_act")
    return h @ p["wo"]


# -------------------------------------------------------------- embeddings

def embed_plan(cfg: ModelConfig) -> Dict:
    V, D = cfg.padded_vocab(), cfg.d_model
    p = {"embedding": PSpec((V, D), ("vocab_act", "wfsdp"), "normal", 1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = PSpec((D, V), ("wfsdp", "vocab_act"), "normal", 1.0)
    return p


def embed_tokens(p, tokens, cfg: ModelConfig, rules: Rules):
    if rules.on_mesh:
        x = _embed_on_mesh(p["embedding"], tokens, rules)
    else:
        x = F.embedding(tokens, p["embedding"])
    return rules.constrain(x, "batch", "seq", "embed_act")


def _embed_on_mesh(w, tokens, rules: Rules):
    """The embedding gather on DTensors: tokens as laid out, the table's
    vocabulary rows as laid out (d_model gathered); each rank's rows of
    other blocks read zero and the output is a partial sum over the
    vocabulary's axes.  A mesh axis that splits the tokens keeps the whole
    vocabulary, and its ranks' gradients of the table are partial sums."""
    from torch.distributed.tensor import Partial, Replicate
    tpl = rules.placements(tokens.shape, ("batch", "seq"))
    wpl = tuple(Replicate() if t.is_shard() else p for t, p in zip(
        tpl, rules.placements(w.shape, ("vocab_act", None))))
    out = tuple(Partial() if p.is_shard() else t for t, p in zip(tpl, wpl))
    wgrad = tuple(Partial() if t.is_shard() else p for t, p in zip(tpl, wpl))
    v0 = global_offset(w.shape, rules.mesh, wpl)[0]

    def local(tl, wl):
        idx = tl.long() - v0
        mine = (idx >= 0) & (idx < wl.shape[0])
        x = F.embedding(idx.clamp(0, wl.shape[0] - 1), wl)
        return torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype))

    return rules.local_map(local, [out], (tpl, wpl), (tpl, wgrad))(tokens, w)


def logits_from(p, x, cfg: ModelConfig, rules: Rules):
    if cfg.tie_embeddings:
        out = x @ p["embedding"].T
    else:
        out = x @ p["unembed"]
    out = rules.constrain(out, "batch", "seq", "vocab_act")
    if cfg.padded_vocab() != cfg.vocab_size:       # mask padding ids
        pad = cfg.padded_vocab() - cfg.vocab_size
        mask = torch.cat([torch.zeros(cfg.vocab_size),
                          torch.full((pad,), -1e9)])
        out = out + mask.to(out.device, out.dtype)
    return out


def cross_entropy(logits, labels, vocab_size: int) -> torch.Tensor:
    """Mean next-token loss, fp32, numerically stable."""
    logits = logits.float()
    m = logits.amax(-1, keepdim=True).detach()
    if is_dtensor(m):
        # the max over a sharded vocabulary, made whole on every rank once:
        # PyTorch 2.11's DTensor cannot add its partial max to the partial
        # sum below
        from torch.distributed.tensor import Replicate
        m = m.redistribute(m.device_mesh, [
            Replicate() if p.is_partial() else p for p in m.placements])
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(-1)) + m[..., 0]
    gold = _pick(shifted, labels) + m[..., 0]
    return (lse - gold).mean()


def _pick(x, labels):
    """``x[..., labels]`` along the last dimension.  On a DTensor whose
    last dimension is sharded, each rank picks from its own block (zero
    where the label lies in another) and the picks are a partial sum over
    that dimension's axes."""
    if not is_dtensor(x):
        return torch.gather(x, -1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    d = x.ndim - 1
    xpl = tuple(x.placements)
    lpl = [Replicate() if p.is_shard(d) else p for p in xpl]
    out = [Partial() if p.is_shard(d) else p for p in xpl]
    v0 = global_offset(x.shape, x.device_mesh, xpl)[d]

    def local(xl, ll):
        idx = ll.long() - v0
        mine = (idx >= 0) & (idx < xl.shape[-1])
        picked = torch.gather(xl, -1, idx.clamp(0, xl.shape[-1] - 1)[..., None])
        return torch.where(mine, picked[..., 0], torch.zeros((), dtype=xl.dtype))

    return local_map(local, out_placements=out, in_placements=(list(xpl), lpl),
                     redistribute_inputs=True)(x, labels)


# ------------------------------------------------------------------ rotary

def rope(x, positions, theta: float):
    """x: (B, S, H, hd), positions: (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    dev = x.device
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=dev) / half))
    angles = positions[..., None].float() * freqs              # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d: int, offset=0, device=None):
    pos = torch.arange(seq, device=device)[:, None] + offset
    dim = torch.arange(d // 2, device=device)[None, :]
    angle = pos / (10000 ** (2 * dim / d))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
