"""The kind of configuration whose work is one served request of a model,
run through the port's normal path: ``configs.get`` → ``models.build`` →
``launch.serve.serve``.

The configuration file holds the model's published keys (its
``config.json``), ``program``, the port's registered name of the model, and
``num_layers``, the depth run; the model run is the registered one cut to
``num_layers``, and every published key must equal what the port
registered (else the run stops before any weight is drawn).  Set-up
builds or loads the kernels the mix names, draws the weights on the card
from the run's seed (`Model.init`, then the attention projections scaled
to unit fan-in), and serves one warm-up request.

A job is one request: a prompt of the mix's ``prompt_tokens`` drawn
uniformly over the vocabulary from the run's seed and the job's index,
served by ``serve`` with the mix's ``slots`` and ``max_seq`` until it has
its ``new_tokens`` tokens by greedy decoding; ``serve`` ends in a
synchronize.  The logits of the prompt's last position and of every decode
step, and the dropless router's expert choices (``moe.DROPLESS.routes``),
are kept for the check.  The traced window profiles whole requests
and adds, for each of the program's spans, its host time and the device
time of the operations launched inside it (``ctx.extra["spans"]``).

The check holds the request drawn from the seed out of the window's (and
the traced window's last) to the program's reference: its float32 forward
over the prompt and the program's own tokens (teacher-forced), computed
layer by layer beside the program's weights, at the same positions;
``max_rel_err`` = max |Δ| / max |ref|.  The reference routes each token to
the experts the program chose (near-equal router probabilities swap on
rounding, and one swapped token moves its logits far), and
``route_margin`` holds those choices to the reference's own: the most its
top-2 probabilities sum to above the chosen two's.  Every assignment is
routed and none dropped, and on the card kernel 5 launches once a
prefill.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from portbench.lib.compare import Check, max_rel_err
from portbench.lib.jobs import Reservoir, closed_loop, job_seed
from portbench.lib.plugins import load_module
from portbench.lib.spans import profile_spans

#: the warm-up job's index (the window's jobs are 0, 1, …)
WARMUP = -1
#: the window's requests held to the reference, drawn from the seed
CHECKED_JOBS = 1
#: the traced window: whole requests, at least this many and this long
TRACE_JOBS = 2
TRACE_SECONDS = 0.0
#: the program's profiler spans the traced window reads
SPANS = ("hybrid.mamba", "hybrid.mamba.scan", "hybrid.moe", "hybrid.attn",
         "hybrid.mlp", "serve.prefill", "serve.decode_step")
#: published keys of the configuration and the port's fields they set
FIELDS = {
    "hidden_size": "d_model",
    "intermediate_size": "d_ff", "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads", "vocab_size": "vocab_size",
    "num_experts": "num_experts", "num_experts_per_tok": "experts_per_token",
    "expert_layer_period": "moe_every", "expert_layer_offset": "moe_offset",
    "attn_layer_period": "attn_period", "mamba_d_state": "ssm_state_dim",
    "mamba_d_conv": "ssm_conv_width", "mamba_expand": "ssm_expand",
    "mamba_dt_rank": "ssm_dt_rank", "tie_word_embeddings": "tie_embeddings",
}
#: published keys whose value the port's hybrid layers implement as such
FIXED = {"hidden_act": "silu", "rms_norm_eps": 1e-6, "mamba_conv_bias": True,
         "mamba_proj_bias": False, "sliding_window": None}


class NotTheModel(ValueError):
    """The port's registered model is not the configuration's."""


def model_config(registered, config: dict):
    """The registered config cut to the file's ``num_layers``, after every
    published key of the file is checked against it."""
    if config["num_hidden_layers"] != registered.num_layers:
        raise NotTheModel(f"{registered.name} has {registered.num_layers} "
                          f"layers, the source {config['num_hidden_layers']}")
    cfg = dataclasses.replace(registered, num_layers=config["num_layers"])
    wrong = {k: (config[k], getattr(cfg, f)) for k, f in FIELDS.items()
             if config[k] != getattr(cfg, f)}
    wrong.update({k: (config[k], v) for k, v in FIXED.items()
                  if config[k] != v})
    if config["attn_layer_offset"] != cfg.attn_period // 2:
        wrong["attn_layer_offset"] = (config["attn_layer_offset"],
                                      cfg.attn_period // 2)
    if cfg.capacity_factor is not None or cfg.moe_norm_topk \
            or not cfg.ssm_dt_rank or cfg.rope_theta:
        wrong["router, mixer or positions"] = ("jamba's", "the port's")
    if wrong:
        raise NotTheModel(f"{registered.name} against the configuration "
                          f"(file, port): {wrong}")
    return cfg


def unit_fan_in(params) -> None:
    """Scale, in place, the stacked attention projections to std 1 /
    sqrt(their contraction): (…, D, heads, hd) by sqrt(heads / D) and
    (…, heads, hd, D) by sqrt(1 / heads).  `Model.init` takes the head
    count or width as their fan-in."""
    attn = params["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        attn[name].mul_((attn[name].shape[-2] / attn[name].shape[-3]) ** 0.5)
    attn["wo"].mul_((1.0 / attn["wo"].shape[-3]) ** 0.5)


class Recording:
    """The model as ``serve`` sees it, keeping the last position's logits
    of each prefill and decode step, and the host clock at each call."""

    def __init__(self, model) -> None:
        self.model = model
        self.logits = []
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill_fn(self, params, batch, rules, cache):
        self.calls.append(time.perf_counter())
        logits, cache = self.model.prefill_fn(params, batch, rules, cache)
        self.logits.append(logits[0, -1].clone())
        return logits, cache

    def decode_fn(self, params, batch, cache, rules):
        self.calls.append(time.perf_counter())
        logits, cache = self.model.decode_fn(params, batch, cache, rules)
        self.logits.append(logits[0, -1].clone())
        return logits, cache

    def decode_graph(self, params, cache, rules, batch):
        step = self.model.decode_graph(params, cache, rules, batch)

        def recorded(tokens, pos):
            self.calls.append(time.perf_counter())
            logits = step(tokens, pos)
            self.logits.append(logits[0, -1].clone())
            return logits

        return recorded


class HybridRequest:
    def __init__(self, folder: Path, ctx, log) -> None:
        # the program first: a checkout without it stops here, before any
        # weight is drawn
        from repro_torch import configs

        config, mix = ctx.config, ctx.mix
        self.config, self.mix, self.log = config, mix, log
        self.bundle = configs.get(config["program"])
        self.cfg = model_config(self.bundle.model, config)
        self.prompt_tokens = int(mix["prompt_tokens"])
        self.new_tokens = int(mix["new_tokens"])
        self.slots, self.max_seq = int(mix["slots"]), int(mix["max_seq"])
        if self.prompt_tokens + self.new_tokens > self.max_seq:
            raise ValueError("the cache holds fewer positions than a request")
        self.reference = load_module(folder / "reference", config["program"])
        self.device = torch.device(ctx.device)
        self.cuda = self.device.type == "cuda"
        self.seed = ctx.seed
        self.samples = []
        self.phases = []        # (prefill s, decode s) of each request
        ctx.work = self.reference.work(config, self.prompt_tokens,
                                       self.new_tokens)

    # ------------------------------------------------------------ set-up --
    def setup(self, ctx) -> None:
        from repro_torch.kernels import cuda_lib
        from repro_torch.launch.serve import serve
        from repro_torch.models import build, moe, ssm

        self.serve, self.cuda_lib, self.moe, self.ssm = serve, cuda_lib, moe, \
            ssm
        if self.cuda:
            t = time.perf_counter()
            built = cuda_lib.build_all([getattr(cuda_lib, k)
                                        for k in self.mix["kernels"]])
            ctx.spans["load"] = time.perf_counter() - t
            print(f"kernels built (s, 0 where loaded): {built}",
                  file=self.log)
        t = time.perf_counter()
        self.model = build(self.cfg, self.bundle.parallel_for("", False))
        self.params = self.model.init(job_seed(self.seed, "weights") % 2 ** 31,
                                      self.device)
        unit_fan_in(self.params)
        if self.cuda:
            torch.cuda.synchronize(self.device)
        ctx.spans["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        self.job(WARMUP)
        ctx.spans["warmup"] = time.perf_counter() - t

    def counters(self) -> dict:
        return {"FLASH_ATTENTION": self.cuda_lib.FLASH_ATTENTION.launches,
                "moe_routed": self.moe.DROPLESS.routed,
                "moe_dropped": self.moe.DROPLESS.dropped,
                "scan_blocks": self.ssm.SCAN.blocks}

    # -------------------------------------------------------------- jobs --
    def prompt(self, seed: int, index: int) -> np.ndarray:
        """Request ``index``'s prompt: uniform over the vocabulary."""
        gen = torch.Generator().manual_seed(job_seed(seed, index))
        return torch.randint(0, self.cfg.vocab_size, (self.prompt_tokens,),
                             generator=gen, dtype=torch.int32).numpy()

    def job(self, index: int, seed=None):
        """One request served; returns (prompt, tokens, logits (n, V),
        routes: each dropless MoE call's expert choices)."""
        from repro_torch.serve import Request

        prompt = self.prompt(self.seed if seed is None else seed, index)
        req = Request(index, prompt, max_new_tokens=self.new_tokens)
        model = Recording(self.model)
        self.moe.DROPLESS.routes = []
        try:
            done, _ = self.serve(model, self.params, [req], self.slots,
                                 self.max_seq, self.device)
            routes = self.moe.DROPLESS.routes
        finally:
            self.moe.DROPLESS.routes = None
        end = time.perf_counter()
        if len(model.calls) > 1:    # the first decode step's start
            self.phases.append((model.calls[1] - model.calls[0],
                                end - model.calls[1]))
        return prompt, done[0].generated, torch.stack(model.logits), routes

    def window(self, seconds: float, ctx) -> None:
        kept = Reservoir(CHECKED_JOBS, self.seed)
        before = self.counters()
        self.phases = []
        ctx.jobs, ctx.window_s = closed_loop(self.job, seconds, kept)
        ctx.launches = {k: n - before[k] for k, n in self.counters().items()}
        ctx.extra["attempted"] = ctx.jobs
        self.samples = [out for _, out in kept.kept]
        print(f"window: {ctx.jobs} requests in {ctx.window_s:.3f} s; "
              f"counters {ctx.launches}; largest expert load "
              f"{self.moe.DROPLESS.max_load}; (prefill s, decode s) a "
              f"request {self.phases}", file=self.log)

    def traced(self, ctx) -> None:
        first = ctx.jobs
        out, ctx.trace, spans = profile_spans(
            lambda j: self.job(first + j), TRACE_SECONDS, TRACE_JOBS,
            self.cuda, SPANS)
        ctx.extra["spans"] = spans
        ctx.extra["attempted"] += ctx.trace.jobs
        self.samples.append(out)
        print(f"spans: {json.dumps(spans)}", file=self.log)

    # ------------------------------------------------------------- check --
    def moe_layers(self) -> int:
        cfg = self.cfg
        return sum(i % cfg.moe_every == cfg.moe_offset % cfg.moe_every
                   for i in range(cfg.num_layers))

    def layer_routes(self, calls):
        """The program's dropless calls' choices (a prefill's layers, then
        each decode step's) as each MoE layer's over the whole sequence."""
        n = self.moe_layers()
        return [torch.cat(calls[layer::n]) for layer in range(n)]

    def reference_logits(self, prompt, tokens, routes=None, **control):
        """The reference's logits at the positions the program's were
        taken: the prompt's last and each decode step's input; routed as
        ``routes`` (each MoE layer's choices) where given; ``control``: the
        reference's ``record`` and its controls' knobs."""
        n = len(tokens)
        seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
        S = len(prompt)
        return self.reference.forward(
            self.params, torch.as_tensor(seq, device=self.device), self.cfg,
            at=torch.arange(S - 1, S - 1 + n, device=self.device),
            routes=routes, **control)

    def compare(self, sample):
        """(max_rel_err, route_margin) of one kept request."""
        prompt, tokens, logits, calls = sample
        record = {}
        want = self.reference_logits(prompt, tokens, self.layer_routes(calls),
                                     record=record)
        return (max_rel_err(logits[:, :self.cfg.vocab_size], want),
                record["margin"])

    def check(self, ctx) -> list:
        limits = self.config["limits"]
        errs, margins = [], []
        while self.samples:
            err, margin = self.compare(self.samples.pop(0))
            errs.append(err)
            margins.append(margin)
        worst = (float("nan") if any(e != e for e in errs) else max(errs))
        ctx.extra["failed"] = sum(
            not (e <= limits["max_rel_err"] and m <= limits["route_margin"])
            for e, m in zip(errs, margins))
        tokens = self.prompt_tokens + self.new_tokens - 1
        checks = [Check("max_rel_err", worst, float(limits["max_rel_err"])),
                  Check("route_margin", max(margins),
                        float(limits["route_margin"])),
                  Check("routed_per_request", ctx.launches["moe_routed"]
                        / ctx.jobs, float(tokens * self.moe_layers()
                                          * self.cfg.experts_per_token), "=="),
                  Check("dropped_assignments",
                        float(ctx.launches["moe_dropped"]), 0.0, "==")]
        if self.cuda:       # the plain version on a CPU launches nothing
            checks.append(Check("kernel5_launches_per_prefill",
                                ctx.launches["FLASH_ATTENTION"] / ctx.jobs,
                                1.0, "=="))
        return checks


def make(folder: Path, ctx, log) -> HybridRequest:
    return HybridRequest(folder, ctx, log)
