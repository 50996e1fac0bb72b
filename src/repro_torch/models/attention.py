"""GQA attention: flash attention for train/prefill, and flash-decoding
against the KV cache for decode.

The port of `repro.models.attention`.  The reference's chunked online-softmax
attention is the oracle of its Pallas flash-attention kernel, which its `ops`
swaps in on the accelerator.  Here train and prefill do the same by device
(`self_attention`): kernel 5 (`kernels.flash_attention.kernel.
flash_attention`, ``csrc/flash_attention.cu``) on a CUDA tensor and
`chunked_attention` (the reference's function, in
`kernels.flash_attention.ref`) on a CPU one.  Both compute causal softmax
attention at scale hd^-½ with query head h reading kv head h % KV, and
under autograd the kernel's gradient is `chunked_attention`'s (the
wrapper's `autograd.Function`).
Decode stays `decode_attention`, in PyTorch, as the reference computes it in
XLA: its ``kv_len`` mask and int8 scales are no part of kernel 5.  The
encoder's non-causal self attention is kernel 5 too.  Cross attention
(Sq ≠ Skv) runs `chunked_attention` on every device, as in the reference.

The KV cache is a dict of stacked tensors, (L, B, S, KV, hd), written in
place: `cache_write_token` and `cache_write_layer` update the tensor they
are given and return it, as XLA aliases the reference's carried cache.  A
view of some batch rows is written through to the whole cache (the serving
launcher prefills one slot's rows so).

On a DeviceMesh (`Rules.on_mesh`) every tensor is a DTensor.  Train and
prefill attention (kernel 5, or `chunked_attention` on the CPU) and cross
attention run under `local_map` on each rank's (batch, heads) block of q,
with the whole sequence (a sharded ``"seq"`` is gathered first, as GSPMD
gathers around a custom call) and every kv head: query head h reads kv head
h % KV, so a block of whole groups of KV heads reads all of them in order,
and any other block reads its own selection.  Heads and batch rows are
independent, so each rank launches the same kernel on its own block, and
the kernel's `autograd.Function` sees local tensors only.  Decode attention
reads a cache whose ``kv_seq`` is sharded (the reference's serving layout):
each rank scores its own positions, and the shards meet in the softmax's
max and sum and in the output's sum over the kv_seq axes.  The cache writes go to each rank's own block of positions.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention.kernel import flash_attention
from ..kernels.flash_attention.ref import NEG, chunked_attention
from .common import PSpec
from .layers import norm_scale, rms_head, rope, scaled
from .sharding import (Rules, drop_leading, global_offset, local_tensor,
                       unshard)


def attn_plan(cfg: ModelConfig) -> Dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    p = {
        "wq": PSpec((D, H, hd), ("wfsdp", "heads", None), "normal", 1.0),
        "wk": PSpec((D, KV, hd), ("wfsdp", "kv_heads", None), "normal", 1.0),
        "wv": PSpec((D, KV, hd), ("wfsdp", "kv_heads", None), "normal", 1.0),
        "wo": PSpec((H, hd, D), ("heads", None, "wfsdp"), "normal", 1.0),
    }
    if cfg.qkv_bias:
        p["bq"] = PSpec((H, hd), ("heads", None), "zeros")
        p["bk"] = PSpec((KV, hd), ("kv_heads", None), "zeros")
        p["bv"] = PSpec((KV, hd), ("kv_heads", None), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = norm_scale(hd)
        p["k_norm"] = norm_scale(hd)
    return p


def _heads_in(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one product."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).unflatten(-1, (H, hd))


def _heads_out(o, w):
    """einsum("bshk,hkd->bsd", o, w) as one product."""
    H, hd, D = w.shape
    return o.flatten(-2) @ w.reshape(H * hd, D)


def _project_qkv(p, x, cfg: ModelConfig, rules: Rules, positions):
    q = _heads_in(x, p["wq"])
    k = _heads_in(x, p["wk"])
    v = _heads_in(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q, k = rms_head(q, p["q_norm"]), rms_head(k, p["k_norm"])
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = rules.constrain(q, "batch", "seq", "heads", None)
    k = rules.constrain(k, "batch", "seq", "kv_heads", None)
    v = rules.constrain(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def self_attention(q, k, v, causal: bool = True):
    """Train/prefill attention, q (B,S,H,hd) against k, v (B,S,KV,hd) of the
    same S: kernel 5 on a CUDA tensor (its tiles take any S),
    `chunked_attention` on a CPU one."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal)


def _call_self_attention(q, k, v, causal):
    """`self_attention`, looked up when called (a caller may replace the
    module's function to check each call)."""
    return self_attention(q, k, v, causal=causal)


def _attend(fn, q, k, v, causal: bool, rules: Rules):
    """``fn(q, k, v, causal=…)``; on a DeviceMesh on each rank's (batch,
    heads) block of q, the whole sequence and the kv heads that block
    reads (see the module docstring)."""
    if not rules.on_mesh:
        return fn(q, k, v, causal=causal)
    from torch.distributed.tensor import Partial
    KV = k.shape[2]
    qpl = rules.placements(q.shape, ("batch", None, "heads", None))
    kpl = rules.placements(k.shape, ("batch", None, None, None))
    h0 = global_offset(q.shape, rules.mesh, qpl)[2]

    def local(ql, kl, vl):
        Hl = ql.shape[2]
        if Hl % KV:               # a block of heads that are not whole groups
            idx = (h0 + torch.arange(Hl, device=ql.device)) % KV
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        return fn(ql, kl, vl, causal=causal)

    # ranks that split the heads each read every kv head: their gradients
    # of k and v are parts of one sum
    kgrad = tuple(Partial() if a.is_shard(2) else b
                  for a, b in zip(qpl, kpl))
    return rules.local_map(local, [qpl], (qpl, kpl, kpl),
                           (qpl, kgrad, kgrad))(q, k, v)


def _decode_on_mesh(q, k_cache, v_cache, kv_len, rules: Rules, k_scale,
                    v_scale):
    """`decode_attention` on DTensors: each rank scores its block of cache
    positions against every head of its batch rows, and the blocks meet
    over the kv_seq axes in the softmax's max and sum and in the output's
    sum.  The operations are `decode_attention`'s, in its order, so a mesh
    whose positions are whole on each rank computes its values exactly."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    mesh = rules.mesh
    cpl = unshard(k_cache.placements, (2,))          # every kv head
    qpl = tuple(p if p.is_shard(0) else Replicate() for p in cpl)
    groups = [mesh.get_group(i) for i, p in enumerate(cpl) if p.is_shard(1)]
    s0 = global_offset(k_cache.shape, mesh, cpl)[1]
    scales = () if k_scale is None else (k_scale, v_scale)

    def local(ql, kl, vl, *sc):
        B, _, H, hd = ql.shape
        S, KVh = kl.shape[1], kl.shape[2]
        qg = scaled(ql.reshape(B, 1, H // KVh, KVh, hd)[:, 0], hd ** -0.5)
        s = torch.einsum("bghd,bshd->bghs", qg.float(), kl.float())
        if sc:
            s = s * torch.movedim(sc[0][..., 0], 1, -1)[:, None]
        pos = s0 + torch.arange(S, device=ql.device)
        s = torch.where((pos < kv_len)[None, None, None, :], s, NEG)
        m = s.amax(-1, keepdim=True)
        for g in groups:
            dist.all_reduce(m, dist.ReduceOp.MAX, group=g)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        for g in groups:
            dist.all_reduce(l, group=g)
        p = p / l
        if sc:
            p = p * torch.movedim(sc[1][..., 0], 1, -1)[:, None]
        out = torch.einsum("bghs,bshd->bghd", p.float(), vl.float())
        for g in groups:
            dist.all_reduce(out, group=g)
        return out.reshape(B, 1, H, hd).to(ql.dtype)

    ins = (qpl, cpl, cpl) + (cpl, cpl)[:len(scales)]
    return rules.local_map(local, [qpl], ins)(q, k_cache, v_cache, *scales)


def decode_attention(q, k_cache, v_cache, kv_len, rules: Rules,
                     k_scale=None, v_scale=None):
    """One-token flash decoding against the KV cache.

    q: (B, 1, H, hd); caches: (B, S, KV, hd).  int8 caches come with
    per-(token, head) scales (B, S, KV, 1); the scale is applied to the
    *scores* / probabilities, so the cache reads stay int8."""
    if rules.on_mesh:
        return _decode_on_mesh(q, k_cache, v_cache, kv_len, rules, k_scale,
                               v_scale)
    B, _, H, hd = q.shape
    _, S, KVh, _ = k_cache.shape
    G = H // KVh
    qg = scaled(q.reshape(B, 1, G, KVh, hd)[:, 0], hd ** -0.5)  # (B,G,KV,hd)
    s = torch.einsum("bghd,bshd->bghs", qg.float(), k_cache.float())
    if k_scale is not None:                                    # (B,S,KV,1)
        s = s * torch.movedim(k_scale[..., 0], 1, -1)[:, None]  # (B,1,KV,S)
    valid = (torch.arange(S, device=q.device) < kv_len)[None, None, None, :]
    s = torch.where(valid, s, NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    p = p / l
    if v_scale is not None:
        p = p * torch.movedim(v_scale[..., 0], 1, -1)[:, None]
    out = torch.einsum("bghs,bshd->bghd", p.float(), v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attention(p, x, cfg: ModelConfig, rules: Rules, mode: str,
              positions, cache: Optional[Dict] = None,
              kv_len=None, causal: bool = True, layer_idx=None):
    """Returns (y, new_cache).

    cache = {"k": (L,B,S,KV,hd), "v": …} — the FULL stacked cache;
    `layer_idx` selects this layer's slice.  Decode writes only the current
    token's (B,1,KV,hd) slot."""
    q, k, v = _project_qkv(p, x, cfg, rules, positions)
    new_cache = cache
    int8_kv = cache is not None and "k_scale" in cache
    if mode == "train":
        o = _attend(_call_self_attention, q, k, v, causal, rules)
    elif mode == "prefill":
        o = _attend(_call_self_attention, q, k, v, causal, rules)
        if cache is not None:
            new_cache = dict(cache)          # preserve non-KV keys (hybrid)
            kq, ks = _quantize_kv(k, int8_kv)
            vq, vs = _quantize_kv(v, int8_kv)
            new_cache["k"] = cache_write_layer(cache["k"], layer_idx, kq, rules)
            new_cache["v"] = cache_write_layer(cache["v"], layer_idx, vq, rules)
            if int8_kv:
                new_cache["k_scale"] = cache_write_layer(
                    cache["k_scale"], layer_idx, ks, rules)
                new_cache["v_scale"] = cache_write_layer(
                    cache["v_scale"], layer_idx, vs, rules)
    elif mode == "decode":
        pos = positions[0, 0]
        kq, ks = _quantize_kv(k, int8_kv)
        vq, vs = _quantize_kv(v, int8_kv)
        new_cache = dict(cache)              # preserve non-KV keys (hybrid)
        new_cache["k"] = cache_write_token(cache["k"], layer_idx, pos, kq, rules)
        new_cache["v"] = cache_write_token(cache["v"], layer_idx, pos, vq, rules)
        ksl = vsl = None
        if int8_kv:
            new_cache["k_scale"] = cache_write_token(
                cache["k_scale"], layer_idx, pos, ks, rules)
            new_cache["v_scale"] = cache_write_token(
                cache["v_scale"], layer_idx, pos, vs, rules)
            ksl = cache_read_layer(new_cache["k_scale"], layer_idx)
            vsl = cache_read_layer(new_cache["v_scale"], layer_idx)
        k_layer = cache_read_layer(new_cache["k"], layer_idx)
        v_layer = cache_read_layer(new_cache["v"], layer_idx)
        o = decode_attention(q, k_layer, v_layer, kv_len, rules,
                             k_scale=ksl, v_scale=vsl)
    else:
        raise ValueError(mode)
    o = rules.constrain(o, "batch", "seq", "heads", None)
    return _heads_out(o, p["wo"]), new_cache


def _quantize_kv(kv, int8: bool):
    """Per-(token, head) symmetric int8 quantization of fresh K/V.  The
    divisor 127 is a tensor on the value's device: CUDA PyTorch divides by a
    Python scalar as a product with its rounded reciprocal, which gives other
    codes than the CPU's exact division."""
    if not int8:
        return kv, None
    a = kv.float()
    scale = a.abs().amax(-1, keepdim=True) / torch.full(
        (), 127.0, device=a.device)
    q = torch.round(a / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


# ------------------------------------------------------- stacked-cache ops

def cache_read_layer(cache, layer_idx):
    """(L,B,S,KV,hd) → (B,S,KV,hd) for this layer (a view)."""
    return cache[layer_idx]


def cache_write_token(cache, layer_idx, pos, kv, rules: Rules):
    """Write one token: (B,1,KV,hd) into (L,B,S,KV,hd) at (layer, :, pos),
    in place.  ``pos`` may be a tensor on the device: it is used as an
    index there, never read back to the host."""
    if rules.on_mesh:
        c, kl, s0 = _local_write(cache, kv)
        at = s0 + torch.arange(c.shape[2], device=c.device) == pos
        c[layer_idx] = torch.where(at[None, :, None, None], kl, c[layer_idx])
        return cache
    index = torch.as_tensor(pos, device=cache.device).reshape(1).long()
    cache[layer_idx].index_copy_(1, index, kv.to(cache.dtype))
    return rules.constrain(cache, None, "batch", "kv_seq", "kv_heads", None)


def cache_write_layer(cache, layer_idx, kv, rules: Rules):
    """Prefill: write a whole layer's fresh KV, zero past its length (the
    reference pads it to the cache length), in place."""
    n = kv.shape[1]
    if rules.on_mesh:
        c, kl, s0 = _local_write(cache, kv)
        m = max(0, min(c.shape[2], n - s0))
        c[layer_idx, :, :m] = kl[:, s0:s0 + m]
        c[layer_idx, :, m:] = 0
        return cache
    cache[layer_idx, :, :n] = kv.to(cache.dtype)
    cache[layer_idx, :, n:] = 0
    return rules.constrain(cache, None, "batch", "kv_seq", "kv_heads", None)


def _local_write(cache, kv):
    """For a write of ``kv`` (B, n, KV, hd) into a DTensor cache (L, B, S,
    KV, hd): the cache's local block (its storage), this rank's rows of kv
    at every position, and the first position of the local block."""
    pl = drop_leading(unshard(cache.placements, (2,)), 1)
    kl = kv.to(cache.dtype).redistribute(cache.device_mesh, pl).to_local()
    s0 = global_offset(cache.shape, cache.device_mesh, cache.placements)[2]
    return local_tensor(cache), kl, s0


def cross_attention(p, x, enc_kv, cfg: ModelConfig, rules: Rules):
    """Decoder→encoder attention; enc_kv = (k, v) precomputed from encoder.
    The output is in v's dtype (`chunked_attention`'s), so a bfloat16 cache
    read by a float32 model meets ``wo`` in their promoted dtype, as jnp
    promotes the reference's product."""
    q = _heads_in(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    k, v = enc_kv
    o = _attend(chunked_attention, q, k, v, False, rules)
    dt = torch.promote_types(o.dtype, p["wo"].dtype)
    return _heads_out(o.to(dt), p["wo"].to(dt))
