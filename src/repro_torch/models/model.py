"""Model assembly for all the reference's architecture families.

The port of `repro.models.model`:

    dense / moe — decoder-only transformer (GQA; qkv bias, qk-norm, parallel
                  attention/MLP block, RMS norm or layernorm, tied
                  embeddings; an MoE MLP where the config has experts)
    hybrid      — jamba: super-blocks of ``attn_period`` sublayers (one
                  attention, the rest Mamba), MoE every ``moe_every`` layers
    ssm         — RWKV-6 (attention-free)
    encdec      — whisper: encoder over ``batch["frames"]`` (non-causal self
                  attention) and decoder with cross-attention

Parameters are stacked over layers (super-blocks for the hybrid), as in the
reference, and a Python loop over the layer index takes the place of its
``jax.lax.scan``.  As the reference's scan does, a train-mode forward that
autograd records rematerializes its layers under ``par.remat == "full"``:
each layer runs under `torch.utils.checkpoint.checkpoint` (non-reentrant),
so only its input is kept and its activations are recomputed in the
backward; with ``remat_block`` dividing L and less than it, blocks of that
many layers are checkpointed too (the reference's two-level remat; not for
the hybrid stack, whose Mamba sublayers are checkpointed one by one
instead).

The KV / state cache is a dict of FULL stacked tensors, written in place
(`attention.cache_write_token`, `cache_write_layer`, `_write1` and
`_write2` here), as XLA aliases the reference's carried cache; `forward`
returns the same tensors.  Each leaf's batch axis is where its plan names
``"batch"``: dim 1, but dim 2 for the hybrid's Mamba leaves, (super-blocks,
attn_period − 1, B, …).  Entry points that allocate (`Model.init`,
`Model.init_cache`) run on the card unless given ``device="cpu"``.

Given rules on a DeviceMesh (`Rules.on_mesh`), every step runs on DTensors:
`Model.distribute` lays the parameters out by `param_specs` and
``init_cache(…, rules=)`` the cache by `cache_specs`, and the stacks run
unchanged, their `rules.constrain` calls redistributing activations as the
reference's ``with_sharding_constraint`` does; the kernels and the MoE
dispatch run on local blocks under `local_map` (`attention`, `rwkv`,
`moe`), and the cache's in-place writes go to each rank's block.  Plain
tensors made inside a step (positions, masks) count as replicated
(`Rules.context`).  The parameters are drawn in full on every rank from the
same seed and each rank keeps its block, so init holds the whole model
once a rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, ParallelConfig
from ..tree import tree_leaves, tree_map
from . import rwkv, ssm
from .attention import (_heads_in, attention, attn_plan, cache_read_layer,
                        cache_write_layer, cross_attention)
from .common import (PSpec, abstract_params, init_params, partition_specs,
                     stack_plan)
from .layers import (apply_mlp, apply_norm, cross_entropy, embed_plan,
                     embed_tokens, logits_from, mlp_plan, norm_plan,
                     sinusoidal_positions)
from .moe import apply_moe, moe_plan
from .sharding import Rules, is_dtensor, set_index

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def _write1(tree_leaf, i, val):
    """Write ``val`` at index i of the leading (layer) dimension, in
    place."""
    if is_dtensor(tree_leaf):
        set_index(tree_leaf, (i,), val)
        return tree_leaf
    tree_leaf[i] = val.to(tree_leaf.dtype)
    return tree_leaf


def _write2(tree_leaf, i, j, val):
    """Write ``val`` at [i, j] of the two leading dimensions (super-block,
    Mamba sublayer), in place."""
    if is_dtensor(tree_leaf):
        set_index(tree_leaf, (i, j), val)
        return tree_leaf
    tree_leaf[i, j] = val.to(tree_leaf.dtype)
    return tree_leaf


def _kv_cache_plan(cfg: ModelConfig, batch: int, seq: int, layers: int,
                   dtype: str = "bfloat16") -> Dict:
    KV, hd = cfg.num_kv_heads, cfg.head_dim_
    sh = (layers, batch, seq, KV, hd)
    nm = (None, "batch", "kv_seq", "kv_heads", None)
    if dtype == "int8":
        ssh = (layers, batch, seq, KV, 1)
        return {"k": PSpec(sh, nm, "zeros", dtype=torch.int8),
                "v": PSpec(sh, nm, "zeros", dtype=torch.int8),
                "k_scale": PSpec(ssh, nm, "zeros", dtype=torch.float32),
                "v_scale": PSpec(ssh, nm, "zeros", dtype=torch.float32)}
    return {"k": PSpec(sh, nm, "zeros", dtype=torch.bfloat16),
            "v": PSpec(sh, nm, "zeros", dtype=torch.bfloat16)}


def _dict_plan_from_shapes(shapes: Dict, layers: int) -> Dict:
    out = {}
    for key, (shape, names, dtype) in shapes.items():
        out[key] = PSpec((layers,) + shape, (None,) + names, "zeros",
                         dtype=_DTYPES[dtype])
    return out


@dataclass
class Model:
    cfg: ModelConfig
    par: ParallelConfig
    plan: Dict

    # ------------------------------------------------------------- params
    def init(self, seed: int, device=None):
        """Parameters drawn from ``seed`` on ``device`` (the card where
        None; without one it raises)."""
        return init_params(seed, self.plan, device)

    def abstract_params(self):
        return abstract_params(self.plan)

    def param_specs(self, rules: Rules):
        return partition_specs(self.plan, rules)

    def distribute(self, params, rules: Rules):
        """``params`` laid out by `param_specs` on the rules' DeviceMesh
        (every rank passes the same full tensors; a mapping returns them
        as they are)."""
        return tree_map(lambda p, x: rules.distribute(x, p.names), self.plan,
                        params)

    # -------------------------------------------------------------- cache
    def cache_plan(self, batch: int, seq: int) -> Dict:
        cfg = self.cfg
        kvdt = self.par.kv_cache_dtype
        if cfg.family in ("dense", "moe"):
            return _kv_cache_plan(cfg, batch, seq, cfg.num_layers, kvdt)
        if cfg.family == "hybrid":
            nsb = cfg.num_layers // cfg.attn_period
            plan = _kv_cache_plan(cfg, batch, seq, nsb, kvdt)
            for key, (shape, names, dtype) in ssm.mamba_cache_shapes(
                    cfg, batch).items():
                plan[f"mamba_{key}"] = PSpec(
                    (nsb, cfg.attn_period - 1) + shape,
                    (None, None) + names, "zeros", dtype=_DTYPES[dtype])
            return plan
        if cfg.family == "ssm":
            return _dict_plan_from_shapes(
                rwkv.rwkv_cache_shapes(cfg, batch), cfg.num_layers)
        if cfg.family == "encdec":
            plan = _kv_cache_plan(cfg, batch, seq, cfg.num_layers)
            plan["xk"] = plan["k"]
            plan["xv"] = plan["v"]
            return plan
        raise ValueError(cfg.family)

    def batch_axes(self) -> Dict[str, int]:
        """Each cache leaf's batch axis, where its plan names ``"batch"``."""
        return {k: spec.names.index("batch")
                for k, spec in self.cache_plan(1, 1).items()}

    def abstract_cache(self, batch: int, seq: int):
        return abstract_params(self.cache_plan(batch, seq))

    def cache_specs(self, batch: int, seq: int, rules: Rules):
        return partition_specs(self.cache_plan(batch, seq), rules)

    def init_cache(self, batch: int, seq: int, device=None, rules=None):
        """An all-zero cache on ``device`` (the card where None), laid out
        by `cache_specs` where ``rules`` are on a DeviceMesh."""
        plan = self.cache_plan(batch, seq)
        cache = init_params(0, plan, device)
        if rules is None:
            return cache
        return tree_map(lambda p, x: rules.distribute(x, p.names), plan,
                        cache)

    # ------------------------------------------------------------ forward
    def forward(self, params, batch: Dict, rules: Rules, mode: str,
                cache=None):
        """batch = {"tokens": (B, S) integer tensor on the parameters'
        device, in decode "pos": the position, a Python int or a 0-d
        tensor on that device, and for the encoder-decoder in train and
        prefill "frames": (B, S_enc, d_model) frame embeddings}.  Returns
        (logits, cache, aux)."""
        with rules.context():
            return self._forward(params, batch, rules, mode, cache)

    def _forward(self, params, batch: Dict, rules: Rules, mode: str, cache):
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        if mode == "decode":
            pos = batch["pos"]
            if isinstance(pos, torch.Tensor):
                positions = pos.reshape(1, 1).expand(B, 1).to(torch.int32)
            else:                     # a fill on the device, no host copy
                positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                                       device=dev)
            kv_len = pos + 1
        else:
            positions = torch.arange(S, device=dev)[None].expand(B, S)
            kv_len = None

        x = embed_tokens(params["embed"], tokens, cfg, rules)
        body = {
            "dense": self._dense_stack, "moe": self._dense_stack,
            "hybrid": self._hybrid_stack, "ssm": self._rwkv_stack,
            "encdec": self._encdec_stack,
        }[cfg.family]
        x, new_cache, aux = body(params, x, positions, rules, mode, cache,
                                 kv_len, batch)
        x = apply_norm(params["final_norm"], x, cfg)
        logits = logits_from(params["embed"], x, cfg, rules)
        return logits, new_cache, aux

    def loss_fn(self, params, batch: Dict, rules: Rules):
        with rules.context():
            return self._loss(params, batch, rules)

    def _loss(self, params, batch: Dict, rules: Rules):
        logits, _, aux = self.forward(params, batch, rules, "train")
        labels = torch.cat(
            [batch["tokens"][:, 1:], batch["tokens"][:, -1:]], dim=1)
        loss = cross_entropy(logits[:, :-1], labels[:, :-1],
                             self.cfg.vocab_size)
        total = loss + 0.01 * aux
        return total, {"loss": loss, "aux": aux}

    def prefill_fn(self, params, batch: Dict, rules: Rules, cache):
        logits, cache, _ = self.forward(params, batch, rules, "prefill", cache)
        return logits[:, -1:], cache

    def decode_fn(self, params, batch: Dict, cache, rules: Rules):
        logits, cache, _ = self.forward(params, batch, rules, "decode", cache)
        return logits, cache

    # ------------------------------------------------------- layer loop
    def _scan_layers(self, body, x, cache, stacked_params, mode: str,
                     rules: Rules, two_level: bool = True):
        """Run ``body(lp, i, x, cache) -> (x, aux, cache)`` over the
        stacked layers, the reference's ``lax.scan`` with the cache in the
        carry, each layer's weights gathered over the fsdp axes where it
        runs (`Rules.gather_fsdp`; inside remat, so the recompute gathers
        again, as XLA's does).  Train mode under autograd: remat (two-level where
        ``two_level`` and ``remat_block`` divides L).  A train forward with
        a cache (which the layers write in place) is not rematerialized: its
        recompute would read the cache after the first forward wrote it."""
        par = self.par
        L = tree_leaves(stacked_params)[0].shape[0]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def layer_params(i):
            return rules.gather_fsdp(tree_map(lambda a: a[i], stacked_params))

        def step(i, x):
            x, a, _ = body(layer_params(i), i, x, None)
            return x, a

        use_remat = (par.remat == "full" and mode == "train"
                     and cache is None and torch.is_grad_enabled())
        if not use_remat:
            for i in range(L):
                x, a, cache = body(layer_params(i), i, x, cache)
                aux = aux + a
            return x, aux, cache

        def layer(i, x):
            return checkpoint(step, i, x, use_reentrant=False)

        nb = par.remat_block if two_level else 0
        if nb and L % nb == 0 and nb < L:
            def block(i0, x):
                a_blk = torch.zeros_like(aux)
                for i in range(i0, i0 + nb):
                    x, a = layer(i, x)
                    a_blk = a_blk + a
                return x, a_blk

            for i0 in range(0, L, nb):
                x, a = checkpoint(block, i0, x, use_reentrant=False)
                aux = aux + a
        else:
            for i in range(L):
                x, a = layer(i, x)
                aux = aux + a
        return x, aux, cache

    # ----------------------------------------------------- family stacks
    def _dense_stack(self, params, x, positions, rules, mode, cache, kv_len,
                     batch):
        cfg = self.cfg
        zero = torch.zeros((), dtype=torch.float32, device=x.device)

        def mlp(p, h):
            if cfg.num_experts > 0:
                return apply_moe(p, h, cfg, rules)
            return apply_mlp(p, h, cfg, rules), zero

        def body(lp, i, x, cache):
            h = apply_norm(lp["attn_norm"], x, cfg)
            a, cache = attention(lp["attn"], h, cfg, rules, mode, positions,
                                 cache, kv_len, layer_idx=i)
            if cfg.parallel_block:
                m, aux = mlp(lp["mlp"], h)
                x = x + a + m
            else:
                x = x + a
                m, aux = mlp(lp["mlp"], apply_norm(lp["mlp_norm"], x, cfg))
                x = x + m
            x = rules.constrain(x, "batch", "seq", "embed_act")
            return x, aux, cache

        x, aux, cache = self._scan_layers(body, x, cache, params["layers"],
                                          mode, rules)
        return x, cache, aux

    def _hybrid_stack(self, params, x, positions, rules, mode, cache, kv_len,
                      batch):
        cfg = self.cfg
        P_ = cfg.attn_period
        attn_j = P_ // 2
        zero = torch.zeros((), dtype=torch.float32, device=x.device)

        def mamba_train(mp, h):
            # per-sublayer remat inside the super-block: its backward
            # otherwise keeps every Mamba sublayer's scan working set live
            def run(mp, h):
                return ssm.apply_mamba(mp, h, cfg, rules, "train", None)[0]
            if torch.is_grad_enabled():
                return checkpoint(run, mp, h, use_reentrant=False)
            return run(mp, h)

        def body(sp, i, x, cache):
            def sub(key, k):            # sublayer k of a stacked group
                return tree_map(lambda t: t[k], sp[key])

            aux = zero
            mi = di = ndense = 0
            for j in range(P_):
                use_moe = j % cfg.moe_every == cfg.moe_offset % cfg.moe_every
                h = apply_norm(sub("pre_norms", j), x, cfg)
                if j == attn_j:
                    a, cache = attention(sp["attn"], h, cfg, rules, mode,
                                         positions, cache, kv_len,
                                         layer_idx=i)
                elif mode == "train":
                    a = mamba_train(sub("mamba", mi), h)
                    mi += 1
                else:
                    mc = None
                    if cache is not None:
                        mc = {"conv": cache["mamba_conv"][i, mi],
                              "ssm": cache["mamba_ssm"][i, mi]}
                    a, mc_new = ssm.apply_mamba(sub("mamba", mi), h, cfg,
                                                rules, mode, mc)
                    if cache is not None and mc_new is not None:
                        cache = dict(cache)
                        cache["mamba_conv"] = _write2(
                            cache["mamba_conv"], i, mi, mc_new["conv"])
                        cache["mamba_ssm"] = _write2(
                            cache["mamba_ssm"], i, mi, mc_new["ssm"])
                    mi += 1
                x = x + a
                h2 = apply_norm(sub("mlp_norms", j), x, cfg)
                if use_moe:
                    m, a2 = apply_moe(sub("moe", di), h2, cfg, rules)
                    aux = aux + a2
                    di += 1
                else:
                    m = apply_mlp(sub("mlp", ndense), h2, cfg, rules)
                    ndense += 1
                x = rules.constrain(x + m, "batch", "seq", "embed_act")
            return x, aux, cache

        x, aux, cache = self._scan_layers(body, x, cache, params["layers"],
                                          mode, rules, two_level=False)
        return x, cache, aux

    def _rwkv_stack(self, params, x, positions, rules, mode, cache, kv_len,
                    batch):
        cfg = self.cfg
        zero = torch.zeros((), dtype=torch.float32, device=x.device)

        def body(lp, i, x, cache):
            tmc = cmc = None
            if cache is not None:
                tmc = {"shift": cache["tm_shift"][i],
                       "state": cache["tm_state"][i]}
                cmc = {"shift": cache["cm_shift"][i]}
            h = apply_norm(lp["tm_norm"], x, cfg)
            a, tm_new = rwkv.apply_time_mix(lp["tm"], h, cfg, rules, mode, tmc)
            x = x + a
            h2 = apply_norm(lp["cm_norm"], x, cfg)
            m, cm_new = rwkv.apply_channel_mix(lp["cm"], h2, cfg, rules, mode,
                                               cmc)
            x = x + m
            x = rules.constrain(x, "batch", "seq", "embed_act")
            if cache is not None:
                cache = dict(cache)
                cache["tm_shift"] = _write1(cache["tm_shift"], i,
                                            tm_new["shift"])
                cache["tm_state"] = _write1(cache["tm_state"], i,
                                            tm_new["state"])
                cache["cm_shift"] = _write1(cache["cm_shift"], i,
                                            cm_new["shift"])
            return x, zero, cache

        x, aux, cache = self._scan_layers(body, x, cache, params["layers"],
                                          mode, rules)
        return x, cache, aux

    def _encdec_stack(self, params, x, positions, rules, mode, cache, kv_len,
                      batch):
        cfg = self.cfg
        dev = x.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        # ---- encoder (train/prefill only; decode uses the cached cross-KV)
        enc_out = None
        if mode != "decode":
            frames = batch["frames"].to(x.dtype)         # (B, S_enc, D) stub
            e = frames + sinusoidal_positions(
                frames.shape[1], cfg.d_model, device=dev).to(x.dtype)[None]
            e = rules.constrain(e, "batch", "seq", "embed_act")
            enc_pos = torch.zeros(e.shape[:2], dtype=torch.int32, device=dev)

            def enc_body(lp, i, e, cache_):
                h = apply_norm(lp["attn_norm"], e, cfg)
                a, _ = attention(lp["attn"], h, cfg, rules, "train", enc_pos,
                                 None, None, causal=False)
                e = e + a
                h2 = apply_norm(lp["mlp_norm"], e, cfg)
                e = e + apply_mlp(lp["mlp"], h2, cfg, rules)
                return rules.constrain(e, "batch", "seq", "embed_act"), \
                    zero, cache_

            enc_out, _, _ = self._scan_layers(enc_body, e, None,
                                              params["encoder"], mode, rules)
            enc_out = apply_norm(params["enc_norm"], enc_out, cfg)

        # positional embedding for decoder tokens
        if mode == "decode":
            x = x + sinusoidal_positions(1, cfg.d_model, offset=batch["pos"],
                                         device=dev).to(x.dtype)[None]
        else:
            x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                         device=dev).to(x.dtype)[None]

        def dec_body(lp, i, x, cache):
            h = apply_norm(lp["attn_norm"], x, cfg)
            a, cache = attention(lp["attn"], h, cfg, rules, mode, positions,
                                 cache, kv_len, layer_idx=i)
            x = x + a
            h2 = apply_norm(lp["xattn_norm"], x, cfg)
            if mode == "decode":
                xk = cache_read_layer(cache["xk"], i)
                xv = cache_read_layer(cache["xv"], i)
            else:
                xk = _heads_in(enc_out, lp["xattn"]["wk"])
                xv = _heads_in(enc_out, lp["xattn"]["wv"])
                if mode == "prefill" and cache is not None:
                    cache = dict(cache)
                    cache["xk"] = cache_write_layer(cache["xk"], i, xk, rules)
                    cache["xv"] = cache_write_layer(cache["xv"], i, xv, rules)
            x = x + cross_attention(lp["xattn"], h2, (xk, xv), cfg, rules)
            h3 = apply_norm(lp["mlp_norm"], x, cfg)
            x = x + apply_mlp(lp["mlp"], h3, cfg, rules)
            x = rules.constrain(x, "batch", "seq", "embed_act")
            return x, zero, cache

        x, aux, cache = self._scan_layers(dec_body, x, cache,
                                          params["decoder"], mode, rules)
        return x, cache, aux


# ================================================================== builders

def _dense_layer_plan(cfg: ModelConfig) -> Dict:
    lp = {"attn_norm": norm_plan(cfg), "attn": attn_plan(cfg)}
    if not cfg.parallel_block:
        lp["mlp_norm"] = norm_plan(cfg)
    lp["mlp"] = moe_plan(cfg) if cfg.num_experts else mlp_plan(cfg)
    return lp


def _hybrid_superblock_plan(cfg: ModelConfig) -> Dict:
    P_ = cfg.attn_period
    n_moe = sum(1 for j in range(P_)
                if j % cfg.moe_every == cfg.moe_offset % cfg.moe_every)
    return {
        "pre_norms": stack_plan(norm_plan(cfg), P_),
        "mlp_norms": stack_plan(norm_plan(cfg), P_),
        "attn": attn_plan(cfg),
        "mamba": stack_plan(ssm.mamba_plan(cfg), P_ - 1),
        "mlp": stack_plan(mlp_plan(cfg), P_ - n_moe),
        "moe": stack_plan(moe_plan(cfg), n_moe),
    }


def _rwkv_layer_plan(cfg: ModelConfig) -> Dict:
    return {"tm_norm": norm_plan(cfg), "tm": rwkv.rwkv_time_mix_plan(cfg),
            "cm_norm": norm_plan(cfg), "cm": rwkv.rwkv_channel_mix_plan(cfg)}


def _encdec_plans(cfg: ModelConfig) -> Tuple[Dict, Dict]:
    enc = {"attn_norm": norm_plan(cfg), "attn": attn_plan(cfg),
           "mlp_norm": norm_plan(cfg), "mlp": mlp_plan(cfg)}
    dec = {"attn_norm": norm_plan(cfg), "attn": attn_plan(cfg),
           "xattn_norm": norm_plan(cfg), "xattn": attn_plan(cfg),
           "mlp_norm": norm_plan(cfg), "mlp": mlp_plan(cfg)}
    return enc, dec


def build(cfg: ModelConfig, par: ParallelConfig) -> Model:
    plan: Dict = {"embed": embed_plan(cfg), "final_norm": norm_plan(cfg)}
    if cfg.family in ("dense", "moe"):
        plan["layers"] = stack_plan(_dense_layer_plan(cfg), cfg.num_layers)
    elif cfg.family == "hybrid":
        nsb = cfg.num_layers // cfg.attn_period
        plan["layers"] = stack_plan(_hybrid_superblock_plan(cfg), nsb)
    elif cfg.family == "ssm":
        plan["layers"] = stack_plan(_rwkv_layer_plan(cfg), cfg.num_layers)
    elif cfg.family == "encdec":
        enc, dec = _encdec_plans(cfg)
        plan["encoder"] = stack_plan(enc, cfg.encoder_layers)
        plan["enc_norm"] = norm_plan(cfg)
        plan["decoder"] = stack_plan(dec, cfg.num_layers)
    else:
        raise ValueError(cfg.family)
    return Model(cfg, par, plan)
