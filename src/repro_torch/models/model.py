"""Model assembly: the decoder-only transformer (dense) and RWKV-6 (ssm)
families.

The port of `repro.models.model` for those two families:

    dense   — decoder-only transformer (GQA; qkv bias, qk-norm, parallel
              attention/MLP block, RMS norm or layernorm, tied embeddings)
    ssm     — RWKV-6 (attention-free)

`build` raises `NotImplementedError` for the reference's other families,
``moe``, ``hybrid`` (jamba) and ``encdec`` (whisper): they wait for later
slices of the port (ROADMAP.md, queue 1, item 2).

Parameters are stacked over layers, as in the reference, and a Python loop
over the layer index takes the place of its ``jax.lax.scan``.  As the
reference's scan does, a train-mode forward that autograd records
rematerializes its layers under ``par.remat == "full"``: each layer runs
under `torch.utils.checkpoint.checkpoint` (non-reentrant), so only its
input is kept and its activations are recomputed in the backward; with
``remat_block`` dividing L and less than it, blocks of that many layers
are checkpointed too (the reference's two-level remat).

The KV / state cache is a dict of FULL stacked tensors, written in place
(`attention.cache_write_token`, `cache_write_layer` and `_write1` here), as
XLA aliases the reference's carried cache; `forward` returns the same
tensors.  Entry points that allocate (`Model.init`, `Model.init_cache`) run
on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, ParallelConfig
from ..tree import tree_leaves, tree_map
from . import rwkv
from .attention import attention, attn_plan
from .common import (PSpec, abstract_params, init_params, partition_specs,
                     stack_plan)
from .layers import (apply_mlp, apply_norm, cross_entropy, embed_plan,
                     embed_tokens, logits_from, mlp_plan, norm_plan)
from .sharding import Rules

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def _write1(tree_leaf, i, val):
    """Write ``val`` at index i of the leading (layer) dimension, in
    place."""
    tree_leaf[i] = val.to(tree_leaf.dtype)
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

    # -------------------------------------------------------------- cache
    def cache_plan(self, batch: int, seq: int) -> Dict:
        cfg = self.cfg
        if cfg.family == "dense":
            return _kv_cache_plan(cfg, batch, seq, cfg.num_layers,
                                  self.par.kv_cache_dtype)
        return _dict_plan_from_shapes(
            rwkv.rwkv_cache_shapes(cfg, batch), cfg.num_layers)

    def abstract_cache(self, batch: int, seq: int):
        return abstract_params(self.cache_plan(batch, seq))

    def cache_specs(self, batch: int, seq: int, rules: Rules):
        return partition_specs(self.cache_plan(batch, seq), rules)

    def init_cache(self, batch: int, seq: int, device=None):
        """An all-zero cache on ``device`` (the card where None)."""
        return init_params(0, self.cache_plan(batch, seq), device)

    # ------------------------------------------------------------ forward
    def forward(self, params, batch: Dict, rules: Rules, mode: str,
                cache=None):
        """batch = {"tokens": (B, S) integer tensor on the parameters'
        device, and in decode "pos": the position, a Python int or a 0-d
        tensor on that device}.  Returns (logits, cache, aux)."""
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
        body = {"dense": self._dense_stack, "ssm": self._rwkv_stack}[
            cfg.family]
        x, new_cache, aux = body(params, x, positions, rules, mode, cache,
                                 kv_len)
        x = apply_norm(params["final_norm"], x, cfg)
        logits = logits_from(params["embed"], x, cfg, rules)
        return logits, new_cache, aux

    def loss_fn(self, params, batch: Dict, rules: Rules):
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
    def _scan_layers(self, body, x, cache, stacked_params, mode: str):
        """Run ``body(lp, i, x, cache) -> (x, aux, cache)`` over the
        stacked layers, the reference's ``lax.scan`` with the cache in the
        carry.  Train mode under autograd: remat (two-level where
        ``remat_block`` divides L).  A train forward with a cache (which
        the layers write in place) is not rematerialized: its recompute
        would read the cache after the first forward wrote it."""
        par = self.par
        L = tree_leaves(stacked_params)[0].shape[0]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def step(i, x):
            lp = tree_map(lambda a: a[i], stacked_params)
            x, a, _ = body(lp, i, x, None)
            return x, a

        use_remat = (par.remat == "full" and mode == "train"
                     and cache is None and torch.is_grad_enabled())
        if not use_remat:
            for i in range(L):
                lp = tree_map(lambda a: a[i], stacked_params)
                x, a, cache = body(lp, i, x, cache)
                aux = aux + a
            return x, aux, cache

        def layer(i, x):
            return checkpoint(step, i, x, use_reentrant=False)

        nb = par.remat_block
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
    def _dense_stack(self, params, x, positions, rules, mode, cache, kv_len):
        cfg = self.cfg
        zero = torch.zeros((), dtype=torch.float32, device=x.device)

        def body(lp, i, x, cache):
            h = apply_norm(lp["attn_norm"], x, cfg)
            a, cache = attention(lp["attn"], h, cfg, rules, mode, positions,
                                 cache, kv_len, layer_idx=i)
            if cfg.parallel_block:
                x = x + a + apply_mlp(lp["mlp"], h, cfg, rules)
            else:
                x = x + a
                h2 = apply_norm(lp["mlp_norm"], x, cfg)
                x = x + apply_mlp(lp["mlp"], h2, cfg, rules)
            x = rules.constrain(x, "batch", "seq", "embed_act")
            return x, zero, cache

        x, aux, cache = self._scan_layers(body, x, cache, params["layers"],
                                          mode)
        return x, cache, aux

    def _rwkv_stack(self, params, x, positions, rules, mode, cache, kv_len):
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
                                          mode)
        return x, cache, aux


# ================================================================== builders

def _dense_layer_plan(cfg: ModelConfig) -> Dict:
    lp = {"attn_norm": norm_plan(cfg), "attn": attn_plan(cfg)}
    if not cfg.parallel_block:
        lp["mlp_norm"] = norm_plan(cfg)
    lp["mlp"] = mlp_plan(cfg)
    return lp


def _rwkv_layer_plan(cfg: ModelConfig) -> Dict:
    return {"tm_norm": norm_plan(cfg), "tm": rwkv.rwkv_time_mix_plan(cfg),
            "cm_norm": norm_plan(cfg), "cm": rwkv.rwkv_channel_mix_plan(cfg)}


#: the reference's families the port does not build yet, and what each waits for
_NOT_PORTED = {"moe": "models/moe.py with the expert combine",
               "hybrid": "models/ssm.py and the hybrid stack",
               "encdec": "the encoder-decoder stack"}


def build(cfg: ModelConfig, par: ParallelConfig) -> Model:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it waits "
            f"for {_NOT_PORTED[cfg.family]} (ROADMAP.md, queue 1, item 2)")
    plan: Dict = {"embed": embed_plan(cfg), "final_norm": norm_plan(cfg)}
    if cfg.family == "dense":
        plan["layers"] = stack_plan(_dense_layer_plan(cfg), cfg.num_layers)
    elif cfg.family == "ssm":
        plan["layers"] = stack_plan(_rwkv_layer_plan(cfg), cfg.num_layers)
    else:
        raise ValueError(cfg.family)
    return Model(cfg, par, plan)
