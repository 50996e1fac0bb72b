"""Mixture-of-Experts with capacity-based grouped dispatch.

The port of `repro.models.moe`.  Tokens are viewed as (groups, T_g), one
group per batch shard (one group on one device); each expert has a buffer
of ``cap`` slots a group, filled in token-major, choice-minor order, and
the combine weights each slot by its gate and sums a token's slots.  The
load-balancing auxiliary loss (Switch-style) is returned alongside.

The reference writes the dispatch and gate buffers with three scatters whose
indices repeat where an expert overflows: every assignment past ``cap`` is
clipped to slot ``cap − 1`` and writes there (a token id of 0, ``False``,
a gate of 0) after the assignment of rank ``cap − 1`` itself, and the last
write wins.  That result is kept here as a rule, with no repeated index in
any scatter: **where expert e receives more than cap assignments in a
group, its slot cap − 1 holds no token**, so the assignment of rank
``cap − 1`` is dropped with those past it and ``cap − 1`` tokens are served.
The buffers are gathers: a stable sort by expert (`torch.sort`, the
reference's stable ``argsort``) gives each expert's run, a running maximum
(`torch.cummax`, its ``associative_scan(jnp.maximum)``) each assignment's
rank in its run, and slot (e, c) reads the sorted assignment at the run's
start + c; the one scatter, which puts the ranks back in assignment order,
writes a permutation.

The combine is deterministic on every device: each token gathers its K
slots and sums them in float32 in one reduction over a fixed-shape K axis,
so the order of the adds is fixed, and the dispatch's backward gathers a
token's K slot gradients the same way (`_Dispatch`); no ``index_add_`` or
``index_put_`` meets a repeated index.  On one device the reference's
``shard_map`` and ``psum`` over the expert axis are the identity.

On a DeviceMesh (`_apply_moe_on_mesh`) the router, its softmax and the
top-k run on DTensors, and the rest is the reference's ``shard_map`` as a
`local_map`: the groups are the batch's shards, so each rank routes its own
group (`route`, `_Dispatch`, `_rows`) over every expert, runs its block of
experts (their d_model gathered) on the slots they hold, and adds its
slots to its tokens in the same fixed-order float32 sum over K; the sum
over the expert axes is then one reduction (``Partial`` → ``Replicate``),
in float32 where the reference sums bf16.  An expert shard's gradients of
the tokens and the gates are parts of one sum over the expert axes, and a
batch shard's gradients of the experts parts of one over the batch axes.

Top-k takes the K largest router probabilities with ties to the lower
expert index, as ``lax.top_k`` does (a stable descending sort).  The
experts' products are `torch.matmul` over the expert dimension (the
reference computes them in ``jnp.einsum``, outside any Pallas kernel).
The gates are the K probabilities renormalized to sum 1, or, where
``cfg.moe_norm_topk`` is False (jamba's router), the probabilities as they
are.

Where ``cfg.capacity_factor`` is None the layer is dropless
(`_apply_moe_dropless`, one device only): the B·S·K assignments are sorted
by expert (stable, so token-major within an expert), each expert's product
runs over its own contiguous rows, and the rows go back to assignment order
by a scatter of a permutation before the same fixed-order float32 combine
over K.  No token is dropped and no row is padded.  `DROPLESS` counts the
assignments it routed and dropped and its largest expert load (plain
integers a run may read and reset; the counts a call needs are on the host
already, to size each expert's product); where its ``routes`` is a list,
each call appends its expert choices, (B·S, K) on the device, in call
order, so that a check can hold a reference to the same routing.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import PSpec
from .sharding import Rules

#: the dropless path's assignments routed and dropped, summed, the most rows
#: one expert took in one call, and (where a list) each call's choices
DROPLESS = SimpleNamespace(routed=0, dropped=0, max_load=0, routes=None)


def moe_plan(cfg: ModelConfig) -> Dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": PSpec((D, E), ("wfsdp", None), "normal", 1.0),
        "wi_gate": PSpec((E, D, F_), ("experts", "wfsdp", None), "normal", 1.0),
        "wi_up": PSpec((E, D, F_), ("experts", "wfsdp", None), "normal", 1.0),
        "wo": PSpec((E, F_, D), ("experts", None, "wfsdp"), "normal", 1.0),
    }


def _num_groups(rules: Rules, batch: int) -> int:
    axes = rules._axes_for("batch", batch, set())
    return int(math.prod(rules.sizes[a] for a in axes)) or 1


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Slots per expert and group: ceil(T_g·K/E·capacity_factor), rounded
    up to a multiple of 4, at least 4 (the reference's rule)."""
    cap = int(math.ceil(tokens_per_group * cfg.experts_per_token
                        / cfg.num_experts * cfg.capacity_factor))
    return max(4, ((cap + 3) // 4) * 4)


def _rows(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """src (G, N, D) at index (G, M) → (G, M, D), a gather."""
    return torch.gather(src, 1, index[..., None].expand(-1, -1, src.shape[-1]))


def route(eidx: torch.Tensor, E: int, cap: int):
    """Slots of the assignments ``eidx`` (G, T_g, K) in buffers of ``cap``
    slots an expert.  Returns ``slot`` (G, T_g, K), the flat slot e·cap + c
    of each assignment (0 where it is dropped), ``kept`` (G, T_g, K), and
    ``disp`` / ``used`` (G, E·cap), each slot's token and whether it holds
    one.  An overflowing expert's slot cap − 1 holds no token (see the
    module docstring)."""
    G, Tg, K = eidx.shape
    TgK = Tg * K
    dev = eidx.device
    eidf = eidx.reshape(G, TgK)
    sorted_e, order = torch.sort(eidf, dim=1, stable=True)
    ar = torch.arange(TgK, device=dev).expand(G, TgK)
    new_run = torch.cat([torch.ones((G, 1), dtype=torch.bool, device=dev),
                         sorted_e[:, 1:] != sorted_e[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(new_run, ar, 0), dim=1).values
    # ranks back in assignment order: a scatter of a permutation
    pos = torch.empty_like(order).scatter_(1, order, ar - run_start)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    start = torch.searchsorted(sorted_e, experts)
    count = torch.searchsorted(sorted_e, experts, right=True) - start
    # the reference's last write at slot cap − 1 of an overflowing expert
    served = torch.where(count > cap, cap - 1, count)               # (G, E)

    kept = pos.reshape(G, Tg, K) < torch.gather(served, 1, eidf).reshape(
        G, Tg, K)
    slot = torch.where(kept, eidx * cap + pos.reshape(G, Tg, K), 0)
    c = torch.arange(cap, device=dev)
    used = c < served[..., None]                                    # (G,E,cap)
    at = torch.clamp(start[..., None] + c, max=TgK - 1).reshape(G, E * cap)
    disp = torch.where(used.reshape(G, E * cap),
                       torch.gather(order, 1, at) // K, 0)
    return slot, kept, disp, used.reshape(G, E * cap)


class _Dispatch(torch.autograd.Function):
    """xe[g, s] = xf[g, disp[g, s]] where slot s is used, else 0; the
    backward sums each token's K slot gradients in a fixed order (a gather,
    no scatter-add)."""

    @staticmethod
    def forward(ctx, xf, disp, used, slot, kept):
        ctx.save_for_backward(slot, kept)
        return torch.where(used[..., None], _rows(xf, disp), 0)

    @staticmethod
    def backward(ctx, grad):
        slot, kept = ctx.saved_tensors
        G, Tg, K = slot.shape
        picked = _rows(grad, slot.reshape(G, Tg * K)).reshape(G, Tg, K, -1)
        dx = torch.where(kept[..., None], picked, 0).sum(2)
        return dx, None, None, None, None


def apply_moe(p, x, cfg: ModelConfig, rules: Rules
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y, aux_loss)."""
    if rules.on_mesh:
        if cfg.capacity_factor is None:
            raise NotImplementedError("dropless routing runs on one device "
                                      "only")
        return _apply_moe_on_mesh(p, x, cfg, rules)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    G = 1 if cfg.capacity_factor is None else _num_groups(rules, B)
    Tg = B * S // G

    xf = rules.constrain(x.reshape(G, Tg, D), "batch", None, "embed_act")
    logits = (xf @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = top[..., :K], idx[..., :K]                      # (G,Tg,K)
    if cfg.moe_norm_topk:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # Switch aux loss: mean fraction routed vs mean router prob per expert
    frac = F.one_hot(eidx[..., 0], E).float().mean((0, 1))
    aux = E * (frac * probs.mean((0, 1))).sum()

    if cfg.capacity_factor is None:
        y = _apply_moe_dropless(p, xf[0], gate[0], eidx[0], E)
        y = rules.constrain(y.reshape(B, S, D), "batch", "seq", "embed_act")
        return y.to(x.dtype), aux.float()

    cap = capacity(Tg, cfg)
    slot, kept, disp, used = route(eidx, E, cap)
    xe = _Dispatch.apply(xf, disp, used, slot, kept)            # (G,E·cap,D)
    xe = xe.reshape(G, E, cap, D).transpose(0, 1).reshape(E, G * cap, D)
    xe = rules.constrain(xe, "experts", "batch", "embed_act")
    h = F.silu(xe @ p["wi_gate"]) * (xe @ p["wi_up"])
    ye = (h @ p["wo"]).reshape(E, G, cap, D).transpose(0, 1)
    ye = rules.constrain(ye, "batch", "experts", None, "embed_act")

    # combine: each token's K slots weighted by their gates and summed in
    # float32 over the fixed-shape K axis, so the order of the adds is fixed
    # (dropped choices weigh 0 and add nothing)
    w = torch.where(kept, gate, 0.0)
    y = (_rows(ye.reshape(G, E * cap, D), slot.reshape(G, Tg * K)).float()
         .reshape(G, Tg, K, D) * w[..., None]).sum(2).to(x.dtype)
    y = rules.constrain(y.reshape(B, S, D), "batch", "seq", "embed_act")
    return y.to(x.dtype), aux.float()


def _apply_moe_dropless(p, xf, gate, eidx, E: int) -> torch.Tensor:
    """Every assignment served: xf (T, D), gate and eidx (T, K) → y (T, D)
    in float32 (see the module docstring).  Where there are no more
    assignments than experts (a decode step), each assignment's expert
    weights are gathered instead, with no host sync, so that a CUDA graph
    may capture the step (its loads then go uncounted in ``max_load``)."""
    T, K = eidx.shape
    flat = eidx.reshape(T * K)
    if T * K <= E:
        rows = xf[:, None].expand(T, K, xf.shape[-1]).reshape(T * K, 1, -1)
        h = F.silu(rows @ p["wi_gate"].index_select(0, flat)) \
            * (rows @ p["wi_up"].index_select(0, flat))
        out = (h @ p["wo"].index_select(0, flat))[:, 0]
        start = T * K
    else:
        order = torch.sort(flat, stable=True).indices  # assignments by expert
        loads = torch.bincount(flat, minlength=E).tolist()
        rows = xf[order // K]                               # (T·K, D), sorted
        parts, start = [], 0
        for e, n in enumerate(loads):
            if n:
                r = rows[start:start + n]
                h = F.silu(r @ p["wi_gate"][e]) * (r @ p["wi_up"][e])
                parts.append(h @ p["wo"][e])
                start += n
        out = torch.empty_like(rows)
        out[order] = torch.cat(parts)          # back to assignment order
        DROPLESS.max_load = max(DROPLESS.max_load, max(loads))
    DROPLESS.routed += T * K
    DROPLESS.dropped += T * K - start
    if DROPLESS.routes is not None:
        DROPLESS.routes.append(eidx)
    return (out.float().reshape(T, K, -1) * gate[..., None]).sum(1)


def _apply_moe_on_mesh(p, x, cfg: ModelConfig, rules: Rules
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`apply_moe` on DTensors (see the module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    G = _num_groups(rules, B)
    cap = capacity(B * S // G, cfg)
    batch_axes = rules._axes_for("batch", B, set())
    expert_axes = rules._axes_for("experts", E, set(batch_axes))
    dims = list(rules.mesh.mesh_dim_names)

    def by_axis(batch, experts, other):
        return tuple(batch if a in batch_axes else experts
                     if a in expert_axes else other for a in dims)

    x = rules.constrain(x, "batch", None, "embed_act")
    logits = (x @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = top[..., :K], idx[..., :K]                     # (B,S,K)
    if cfg.moe_norm_topk:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    rows = by_axis(Shard(0), Replicate(), Replicate())         # tokens
    wpl = by_axis(Replicate(), Shard(0), Replicate())          # experts
    e0 = (rules.shard_index(expert_axes) * E
          // math.prod(rules.sizes[a] for a in expert_axes))

    def local(xl, gl, el, wg, wu, wo):
        Bl = xl.shape[0]
        Tg, El = Bl * S, wg.shape[0]
        xf = xl.reshape(1, Tg, D)
        slot, kept, disp, used = route(el.reshape(1, Tg, K), E, cap)
        # this rank's experts: their slots, and each assignment's slot
        # among them (kept where the assignment is theirs)
        lo, n = e0 * cap, El * cap
        mine = kept & (slot >= lo) & (slot < lo + n)
        lslot = torch.where(mine, slot - lo, 0)
        xe = _Dispatch.apply(xf, disp[:, lo:lo + n], used[:, lo:lo + n],
                             lslot, mine).reshape(El, cap, D)
        h = F.silu(xe @ wg) * (xe @ wu)
        ye = (h @ wo).reshape(1, n, D)
        w = torch.where(mine, gl.reshape(1, Tg, K), 0.0)
        y = (_rows(ye, lslot.reshape(1, Tg * K)).float()
             .reshape(1, Tg, K, D) * w[..., None]).sum(2)
        frac = F.one_hot(el.reshape(Tg, K)[:, 0], E).float().sum(0) / (B * S)
        return y.reshape(Bl, S, D), frac

    y, frac = rules.local_map(
        local,
        [by_axis(Shard(0), Partial(), Replicate()),
         by_axis(Partial(), Replicate(), Replicate())],
        (rows, rows, rows, wpl, wpl, wpl),
        (by_axis(Shard(0), Partial(), Replicate()),
         by_axis(Shard(0), Partial(), Replicate()), rows,
         by_axis(Partial(), Shard(0), Replicate()),
         by_axis(Partial(), Shard(0), Replicate()),
         by_axis(Partial(), Shard(0), Replicate())),
    )(x, gate, eidx, p["wi_gate"], p["wi_up"], p["wo"])
    # Switch aux loss: mean fraction routed vs mean router prob per expert
    aux = E * (frac * probs.mean((0, 1))).sum()
    y = rules.constrain(y, "batch", "seq", "embed_act").to(x.dtype)
    return y, aux.float()
