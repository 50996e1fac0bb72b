"""A plain reference of a Jamba stack (arXiv:2403.19887; AI21-Jamba2-Mini's
config.json): the full forward pass of one prompt in float32, with TF32 off.

It takes the port's parameter tree (`repro_torch.models.model.build` of a
hybrid config: ``embed``, ``final_norm`` and ``layers``, stacked by blocks
of ``attn_period`` layers) and an object with the config's widths as
attributes, and shares no code with the port: it imports torch only.  Each
block's weights are cast up to float32 one sublayer at a time, so the
reference fits on a card beside the program's bf16 weights.

Layer i of a block: ``x += mixer(rms(x))``, then ``x += ffn(rms(x))``.  The
mixer is attention at i = attn_period // 2 and the Mamba-1 mixer elsewhere;
the ffn is the MoE where i % moe_every == moe_offset % moe_every and a
SwiGLU MLP elsewhere.  Then the final RMSNorm and the untied head.

- Attention: GQA, no positional encoding, scale hd^-1/2, a plain causal
  softmax, computed a block of queries at a time.
- Mamba-1: ``in_proj`` → (x, z); a causal depthwise conv of width w with
  bias, tap k of ``conv_w`` on position t − (w − 1) + k; SiLU; ``x_proj``
  → (dt, B, C), each RMS-normed; ``dt = softplus(dt_proj(dt) + dt_bias)``,
  ``A = −exp(A_log)``; the recurrence ``h_t = exp(dt_t·A)·h_{t−1} +
  dt_t·x_t·B_t`` from h = 0, one step at a time, ``y_t = h_t·C_t + D·x_t``;
  ``y·silu(z)``, then ``out_proj``.
- MoE: softmax over all experts of the router's logits, the top
  ``experts_per_token``, gated by their probabilities as they are (not
  renormalized); each token's experts computed directly, expert by expert
  over the tokens that chose it.  Every token is routed.  Given ``routes``
  (a layer's (S, K) expert choices, MoE layers in stack order), the
  reference takes those choices, gated by its own probabilities: routing
  forced by the program's, as its tokens are, since two near-equal
  probabilities swap on rounding.  ``record["margin"]`` is then the most,
  over tokens and layers, that the reference's own top-K probabilities sum
  to above the chosen ones' (0 where the choices are its own).
- RMSNorm: ``x·rsqrt(mean(x²) + 1e-6)·scale``.

Departures from the published description, all of layout or of the random
weights the benchmark draws: query head h attends with kv head h mod KV
(the tree's head layout; the published checkpoint groups query heads by
h // (H/KV), a permutation of wq's and wo's head axis); ``conv_w`` is
stored (w, d_inner); ``dt_bias`` is ``dt_proj``'s bias; no router jitter
or auxiliary loss (a forward pass only).

The controls' knobs, for the readings of the check's limits: with
``state_dtype`` torch.bfloat16 the scan's decay and state are held in bf16;
``level``, a rounding function, rounds every sublayer's normed input and
its output before the residual add (every other step in float32).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS = 1e-6


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for float32 products on the card, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _f32(tree):
    """Every leaf of a nested dict as float32."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _at(tree, *index):
    """Every leaf of a nested dict indexed by ``index``."""
    if isinstance(tree, dict):
        return {k: _at(v, *index) for k, v in tree.items()}
    return tree[index]


def rms(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale


def attention(p, h, cfg, q_block: int = 1024):
    """h (S, D) → (S, D): causal GQA softmax attention."""
    S = h.shape[0]
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = torch.einsum("sd,dhk->shk", h, p["wq"])
    k = torch.einsum("sd,dhk->shk", h, p["wk"])
    v = torch.einsum("sd,dhk->shk", h, p["wv"])
    kv_of = torch.arange(H, device=h.device) % KV
    k, v = k[:, kv_of], v[:, kv_of]                          # (S, H, hd)
    scale = q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    for q0 in range(0, S, q_block):
        q1 = min(S, q0 + q_block)
        s = torch.einsum("qhk,shk->hqs", q[q0:q1], k[:q1]) * scale
        mask = (torch.arange(q1, device=h.device)[None, :]
                <= torch.arange(q0, q1, device=h.device)[:, None])
        s = torch.where(mask[None], s, float("-inf"))
        out[q0:q1] = torch.einsum("hqs,shk->qhk", torch.softmax(s, -1),
                                  v[:q1])
    return torch.einsum("shk,hkd->sd", out, p["wo"])


def mamba(p, h, cfg, state_dtype=torch.float32, chunk: int = 1024):
    """h (S, D) → (S, D): the Mamba-1 mixer, its recurrence one step at a
    time from a zero state."""
    S = h.shape[0]
    ds, R = cfg.ssm_state_dim, cfg.ssm_dt_rank
    w = p["conv_w"].shape[0]
    xin, z = (h @ p["in_proj"]).chunk(2, dim=-1)             # (S, di) each
    xpad = torch.cat([xin.new_zeros(w - 1, xin.shape[1]), xin])
    xc = p["conv_b"] + sum(xpad[k:k + S] * p["conv_w"][k] for k in range(w))
    xc = F.silu(xc)
    dt, Bm, Cm = (xc @ p["x_proj"]).split([R, ds, ds], dim=-1)
    dt = rms(dt, p["dt_norm"])
    Bm, Cm = rms(Bm, p["b_norm"]), rms(Cm, p["c_norm"])
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])         # (S, di)
    A = -torch.exp(p["A_log"])                                # (di, ds)
    h_t = torch.zeros(A.shape, dtype=state_dtype, device=h.device)
    y = torch.empty_like(xc)
    for c0 in range(0, S, chunk):
        c = slice(c0, min(S, c0 + chunk))
        decay = torch.exp(dt[c, :, None] * A).to(state_dtype)
        states = ((dt[c] * xc[c])[:, :, None] * Bm[c, None, :]).to(state_dtype)
        for t in range(states.shape[0]):
            h_t = states[t].addcmul_(decay[t], h_t)   # h_t = a_t·h + b_t
        y[c] = torch.einsum("ldn,ln->ld", states.float(), Cm[c])
    y = (y + xc * p["Dskip"]) * F.silu(z)
    return y @ p["out_proj"]


def moe(p, h, cfg, chosen=None, record=None):
    """h (S, D) → (S, D): every token's top experts (or ``chosen``, (S, K)),
    gated by their router probabilities, computed expert by expert."""
    probs = torch.softmax(h @ p["router"], dim=-1)            # (S, E)
    top, own = torch.topk(probs, cfg.experts_per_token, dim=-1)
    if chosen is None:
        gate, chosen = top, own
    else:
        chosen = chosen.to(device=h.device, dtype=torch.long)
        gate = torch.gather(probs, -1, chosen)
    if record is not None:
        record["routes"].append(chosen)
        record["margin"] = max(record["margin"],
                               float((top.sum(-1) - gate.sum(-1)).max()))
    out = torch.zeros_like(h)
    for e in range(probs.shape[-1]):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel():
            out[tok] += gate[tok, slot, None] * mlp(
                {"wi_gate": p["wi_gate"][e], "wi_up": p["wi_up"][e],
                 "wo": p["wo"][e]}, h[tok])
    return out


def mlp(p, h):
    return (F.silu(h @ p["wi_gate"]) * (h @ p["wi_up"])) @ p["wo"]


def forward(params, tokens, cfg, at=None, state_dtype=torch.float32,
            routes=None, record=None, level=None):
    """Logits (len(at), vocab_size) in float32 of the prompt ``tokens``
    (S,) at positions ``at`` (every position where None).  ``routes``: the
    MoE layers' expert choices, in stack order; ``record``, where a dict,
    gets the choices taken (``"routes"``) and the routing ``"margin"``."""
    P = cfg.attn_period
    blocks = params["layers"]
    if record is not None:
        record.update(routes=[], margin=0.0)
    n_moe = 0
    with _no_tf32(), torch.no_grad():
        lv = level or (lambda a: a)
        x = params["embed"]["embedding"][tokens.long()].float()
        for b in range(cfg.num_layers // P):
            mi = di = nd = 0
            for j in range(P):
                h = lv(rms(x, blocks["pre_norms"]["scale"][b, j].float()))
                if j == P // 2:
                    x = x + lv(attention(_f32(_at(blocks["attn"], b)), h,
                                         cfg))
                else:
                    x = x + lv(mamba(_f32(_at(blocks["mamba"], b, mi)), h,
                                     cfg, state_dtype))
                    mi += 1
                h = lv(rms(x, blocks["mlp_norms"]["scale"][b, j].float()))
                if j % cfg.moe_every == cfg.moe_offset % cfg.moe_every:
                    x = x + lv(moe(_f32(_at(blocks["moe"], b, di)), h, cfg,
                                   None if routes is None else routes[n_moe],
                                   record))
                    di += 1
                    n_moe += 1
                else:
                    x = x + lv(mlp(_f32(_at(blocks["mlp"], b, nd)), h))
                    nd += 1
        x = rms(x if at is None else x[at],
                params["final_norm"]["scale"].float())
        logits = x @ params["embed"]["unembed"].float()
    return logits[:, :cfg.vocab_size]
