"""RWKV-6 (Finch): attention-free time-mix with data-dependent per-channel
decay, + squared-ReLU channel-mix.

The port of `repro.models.rwkv`.  Train/prefill run the *chunkwise-parallel*
form: within a chunk, intra-chunk contributions use decay ratios
exp(cl_t − cl_s) from the log-decay cumsum; across chunks a (B, H, hd, hd)
state is carried — the uniform t−1 → t dependence the paper's classifier
marks FIFO under sequence sharding.  Decode is one recurrent update, O(1) in
sequence length.

Where the chunked form starts from a zero state and keeps none (mode
``"train"`` without a cache), the time-mix core on a CUDA tensor is kernel 6
(`kernels.gla_timemix.kernel.gla_timemix`, ``csrc/gla_timemix.cu``), given
r, k, v, logw and u in float32 and this module's chunk; it computes the same
recurrence, and under autograd its gradient is the chunked form's (the
wrapper's `autograd.Function`).  Kernel 6 takes no initial state and returns
no final state, so prefill with a cache and decode run the chunked form and
the one-step recurrence in PyTorch on every device.

On a DeviceMesh the time-mix core (`_core`: kernel 6, the chunked form or
the recurrent step) runs under `local_map` on each rank's (batch, heads)
block, the sequence whole: heads and batch rows are independent, so each
rank launches the kernel on its own block, never on a DTensor.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.gla_timemix.kernel import gla_timemix
from ..kernels.gla_timemix.ref import chunked_timemix as _chunked
from .attention import _heads_in
from .common import PSpec
from .sharding import Rules

LORA = 64


def rwkv_time_mix_plan(cfg: ModelConfig) -> Dict:
    D = cfg.d_model
    H, hd = cfg.num_heads, cfg.head_dim_
    return {
        "mix_rkvwg": PSpec((5, D), (None, "norm"), "zeros"),
        "wr": PSpec((D, H, hd), ("wfsdp", "heads", None), "normal", 1.0),
        "wk": PSpec((D, H, hd), ("wfsdp", "heads", None), "normal", 1.0),
        "wv": PSpec((D, H, hd), ("wfsdp", "heads", None), "normal", 1.0),
        "wg": PSpec((D, H, hd), ("wfsdp", "heads", None), "normal", 1.0),
        "wo": PSpec((H, hd, D), ("heads", None, "wfsdp"), "normal", 1.0),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x W_a) W_b))
        "w0": PSpec((H, hd), ("heads", None), "zeros"),
        "wa": PSpec((D, LORA), ("wfsdp", None), "normal", 1.0),
        "wb": PSpec((LORA, H, hd), (None, "heads", None), "normal", 0.1),
        "u": PSpec((H, hd), ("heads", None), "zeros"),      # current-token bonus
        "ln_scale": PSpec((H, hd), ("heads", None), "ones"),  # per-head groupnorm
    }


def rwkv_channel_mix_plan(cfg: ModelConfig) -> Dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "mix_kr": PSpec((2, D), (None, "norm"), "zeros"),
        "wk": PSpec((D, F_), ("wfsdp", "wtp"), "normal", 1.0),
        "wv": PSpec((F_, D), ("wtp", "wfsdp"), "normal", 1.0),
        "wr": PSpec((D, D), ("wfsdp", "wfsdp"), "normal", 1.0),
    }


def _token_shift(x, prev):
    """prev-token features; prev: (B, D) last token of previous segment."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def chunk_size(S: int, chunk: int = 64) -> int:
    """The chunk C the chunked form runs S at: the reference's rule, the
    least count of chunks of at most ``chunk`` steps that divides S."""
    nc = max(1, -(-S // min(chunk, S)))
    while S % nc:
        nc += 1
    return S // nc


def apply_time_mix(p, x, cfg: ModelConfig, rules: Rules, mode: str,
                   cache: Optional[Dict], chunk: int = 64
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """cache = {"shift": (B,D), "state": (B,H,hd,hd) fp32}."""
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim_
    prev = (cache["shift"].to(x.dtype) if cache is not None
            else torch.zeros((B, D), dtype=x.dtype, device=x.device))
    xx = _token_shift(x, prev)
    mix = torch.sigmoid(p["mix_rkvwg"].float())                 # (5, D)

    def lerp(i):
        return (x.float() * mix[i] + xx.float() * (1 - mix[i])).to(x.dtype)

    r = _heads_in(lerp(0), p["wr"])
    k = _heads_in(lerp(1), p["wk"])
    v = _heads_in(lerp(2), p["wv"])
    g = _heads_in(lerp(4), p["wg"])
    r = rules.constrain(r, "batch", "seq", "heads", None)
    k = rules.constrain(k, "batch", "seq", "heads", None)
    v = rules.constrain(v, "batch", "seq", "heads", None)

    # data-dependent decay in log space: logw ≤ 0
    lora = torch.tanh((lerp(3) @ p["wa"]).float())
    wln = p["w0"].float() + _heads_in(lora, p["wb"].float())
    logw = -torch.exp(wln)                                      # (B,S,H,hd)
    u = p["u"].float()

    state0 = cache["state"] if cache is not None else None
    core = functools.partial(_core, mode=mode, chunk=chunk_size(S, chunk),
                             want_state=cache is not None or mode != "train")
    if rules.on_mesh:
        y, state = _core_on_mesh(core, r, k, v, logw, u, state0, rules)
    else:
        y, state = core(r, k, v, logw, u, state0)

    # per-head groupnorm-lite + gate
    ms = torch.clamp((y * y).mean(-1, keepdim=True), min=1e-12)
    y = y * torch.rsqrt(ms) * p["ln_scale"].float()
    y = (y * F.silu(g.float())).to(x.dtype)
    out = y.flatten(-2) @ p["wo"].reshape(H * hd, D)
    new_cache = None
    if cache is not None or mode != "train":
        new_cache = {"shift": x[:, -1].to(x.dtype), "state": state}
    return out, new_cache


def _core(r, k, v, logw, u, state0, *, mode: str, chunk: int,
          want_state: bool):
    """The time-mix core, (y, state): the recurrent step in decode, kernel
    6 in a train forward from a zero state on the card (no state), else
    the chunked form from ``state0`` (zero where None)."""
    B, S, H, hd = r.shape
    if mode == "decode":
        r1, k1, v1 = (a[:, 0].float() for a in (r, k, v))
        kv = k1[..., :, None] * v1[..., None, :]                # (B,H,hd,hd)
        y = torch.einsum("bhk,bhkd->bhd", r1, state0 + u[..., None] * kv)
        state = torch.exp(logw[:, 0])[..., None] * state0 + kv
        return y[:, None], state                                # (B,1,H,hd)
    if not want_state and r.device.type == "cuda":
        return gla_timemix(r.float(), k.float(), v.float(), logw, u,
                           chunk=chunk), None
    if state0 is None:
        state0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=r.device)
    return _chunked(r, k, v, logw, u, state0, chunk)


def _core_on_mesh(core, r, k, v, logw, u, state0, rules: Rules):
    """`_core` on each rank's (batch, heads) block (see the module
    docstring).  ``u`` is whole on the batch axes, so the batch shards'
    gradients of it are parts of one sum."""
    from torch.distributed.tensor import Partial
    B, S, H, hd = r.shape
    rpl = rules.placements(r.shape, ("batch", None, "heads", None))
    upl = rules.placements(u.shape, ("heads", None))
    spl = rules.placements((B, H, hd, hd), ("batch", "heads", None, None))
    ugrad = tuple(Partial() if a.is_shard(0) else b for a, b in zip(rpl, upl))
    want_state = core.keywords["want_state"]
    args = (r, k, v, logw, u) + ((state0,) if state0 is not None else ())
    ins = (rpl,) * 4 + (upl,) + ((spl,) if state0 is not None else ())
    grads = (rpl,) * 4 + (ugrad,) + ((spl,) if state0 is not None else ())

    def local(rl, kl, vl, wl, ul, sl=None):
        y, state = core(rl, kl, vl, wl, ul, sl)
        return (y, state) if want_state else y

    outs = [rpl, spl] if want_state else [rpl]
    out = rules.local_map(local, outs, ins, grads)(*args)
    return out if want_state else (out, None)


def apply_channel_mix(p, x, cfg: ModelConfig, rules: Rules, mode: str,
                      cache: Optional[Dict]
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """cache = {"shift": (B, D)}."""
    B, S, D = x.shape
    prev = (cache["shift"].to(x.dtype) if cache is not None
            else torch.zeros((B, D), dtype=x.dtype, device=x.device))
    xx = _token_shift(x, prev)
    mix = torch.sigmoid(p["mix_kr"].float())

    def lerp(i):
        return (x.float() * mix[i] + xx.float() * (1 - mix[i])).to(x.dtype)

    k = lerp(0) @ p["wk"]
    k = torch.square(F.relu(k))
    k = rules.constrain(k, "batch", "seq", "mlp_act")
    vv = k @ p["wv"]
    rr = torch.sigmoid((lerp(1) @ p["wr"]).float()).to(x.dtype)
    out = rr * vv
    new_cache = None
    if cache is not None or mode != "train":
        new_cache = {"shift": x[:, -1].to(x.dtype)}
    return out, new_cache


def rwkv_cache_shapes(cfg: ModelConfig, batch: int):
    H, hd, D = cfg.num_heads, cfg.head_dim_, cfg.d_model
    return {
        "tm_shift": ((batch, D), ("batch", None), "bfloat16"),
        "tm_state": ((batch, H, hd, hd), ("batch", "heads", None, None), "float32"),
        "cm_shift": ((batch, D), ("batch", None), "bfloat16"),
    }
