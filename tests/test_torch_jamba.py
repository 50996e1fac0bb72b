"""jamba2-mini (AI21-Jamba2-Mini) on the port's hybrid path, on the CPU, held
to the plain reference `repro_torch.models.ref_jamba`.

The model is the registered config cut to d_model 64, 8 layers (one
block: attention at 4, Mamba elsewhere, MoE on the odd layers), 4 experts
top-2, dt_rank 8, d_state 16, vocab 512, in float32 (parameters drawn by
`Model.init` and cast; the cache too).  The attention projections are
rescaled to unit fan-in (their init takes the head count as fan-in, whose
large scores amplify rounding).

1. The train forward, and a prefill of S = 64 followed by decoding through
   the cache, against the reference's full forward (teacher-forced on the
   same tokens): logits, never sampled tokens.
2. The published Mamba mixer against the reference's one-step recurrence, in
   train, prefill over several blocks, and prefill then decode.
3. Dropless routing under a skewed input that sends every token to the same
   two experts: nothing dropped, the output the reference's; the capacity
   rule drops there.  A decode step's few rows gather their experts.
4. The gates are the top-2 softmax probabilities, not renormalized.
5. With the new options at their defaults, reduced qwen3-moe-30b-a3b and
   jamba-1.5-large-398b give the outputs of the port before them, bit for
   bit (digests of the logits, the aux loss and the cache).
6. The parameter counts of jamba2-mini and of its 8-layer stage on `meta`.
7. The server prefills a dropless MoE at B = 1 in its own slot, and 4 slots
   give the tokens 1 slot gives; a capacity-routed MoE keeps the broadcast.

Tolerances: the port and the reference compute the same float32 arithmetic
in other orders (the log-step scan against the recurrence, batched against
per-expert products, flash blocks against one softmax), so they agree to a
few float32 roundings, amplified by the depth; 2e-5 of the largest
reference logit holds that with room, and a bf16 rounding of any step
(3.9e-3) would fail it.
"""
import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import Rules, build, moe as moe_mod, ssm  # noqa: E402
from repro_torch.models import ref_jamba  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.serve import Request  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "jamba2-mini"
MESH = {"data": 1, "model": 1}
REL = 2e-5
S = 64


def small_config(**kw):
    return dataclasses.replace(
        configs.get(ARCH).model, num_layers=8, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, num_experts=4,
        experts_per_token=2, ssm_dt_rank=8, ssm_state_dim=16, **kw)


def unit_fan_in(params):
    """The attention projections at std 1/sqrt(their contraction)."""
    attn = params["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        attn[name].mul_((attn[name].shape[-2] / attn[name].shape[-3]) ** 0.5)
    attn["wo"].mul_((1.0 / attn["wo"].shape[-3]) ** 0.5)
    return params


def f32(tree):
    return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                    tree)


@pytest.fixture(scope="module")
def small():
    cfg = small_config()
    bundle = configs.get(ARCH)
    model = build(cfg, bundle.parallel_for("decode_32k", False))
    params = unit_fan_in(f32(model.init(3, "cpu")))
    return model, params, Rules.make(MESH, model.par)


def rel(got, want):
    return float((got.float() - want).abs().max() / want.abs().max())


def tokens(n, seed=0, vocab=512):
    return torch.randint(0, vocab, (n,),
                         generator=torch.Generator().manual_seed(seed))


# ------------------------------------------------ 1. the stack's forward

def test_train_forward_matches_the_reference(small):
    model, params, rules = small
    toks = tokens(S)
    with torch.no_grad():
        logits, _, _ = model.forward(params, {"tokens": toks[None]}, rules,
                                     "train")
    want = ref_jamba.forward(params, toks, model.cfg)
    assert rel(logits[0, :, :512], want) <= REL


@pytest.mark.parametrize("new", [1, 8])
def test_prefill_then_decode_match_the_references_full_forward(small, new):
    model, params, rules = small
    toks = tokens(S + new, seed=new)
    cache = f32(model.init_cache(1, S + new, "cpu"))
    got = []
    with torch.no_grad():
        last, cache = model.prefill_fn(params, {"tokens": toks[None, :S]},
                                       rules, cache)
        got.append(last[0, -1])
        for t in range(S, S + new - 1):
            logits, cache = model.decode_fn(
                params, {"tokens": toks[None, t:t + 1], "pos": t}, cache,
                rules)
            got.append(logits[0, -1])
    want = ref_jamba.forward(params, toks, model.cfg,
                             at=torch.arange(S - 1, S + new - 1))
    assert rel(torch.stack(got)[:, :512], want) <= REL


# ------------------------------------------------ 2. the Mamba mixer

def mixer_params(cfg, seed=4):
    plan = ssm.mamba_plan(cfg)
    p = f32(init_params(seed, plan, "cpu"))
    gen = torch.Generator().manual_seed(seed)
    for name in ("dt_norm", "b_norm", "c_norm", "conv_b"):   # not all ones
        p[name] += 0.3 * torch.randn(p[name].shape, generator=gen)
    return p


@pytest.mark.parametrize("case", ["train", "prefill-blocks", "decode"])
def test_published_mixer_matches_the_sequential_recurrence(case):
    cfg = small_config()
    p = mixer_params(cfg)
    rules = Rules.make(MESH, configs.get(ARCH).parallel_for("decode_32k",
                                                            False))
    x = torch.randn(1, 40, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    want = ref_jamba.mamba(p, x[0], cfg, chunk=16)
    before = ssm.SCAN.blocks
    with torch.no_grad():
        if case == "train":
            y, _ = ssm.apply_mamba(p, x, cfg, rules, "train")
        elif case == "prefill-blocks":
            y, _ = ssm.apply_mamba(p, x, cfg, rules, "prefill", block=8)
            assert ssm.SCAN.blocks - before == 5
        else:
            di = cfg.ssm_expand * cfg.d_model
            cache = {"conv": torch.zeros(1, cfg.ssm_conv_width - 1, di),
                     "ssm": torch.zeros(1, di, cfg.ssm_state_dim)}
            ys = []
            y0, cache = ssm.apply_mamba(p, x[:, :24], cfg, rules, "prefill",
                                        cache)
            ys.append(y0)
            for t in range(24, 40):
                yt, cache = ssm.apply_mamba(p, x[:, t:t + 1], cfg, rules,
                                            "decode", cache)
                ys.append(yt)
            y = torch.cat(ys, dim=1)
    assert rel(y[0], want) <= REL


def test_published_mixer_plan_and_init():
    cfg = configs.get(ARCH).model
    plan = ssm.mamba_plan(cfg)
    assert plan["x_proj"].shape == (8192, 256 + 32)
    assert plan["dt_proj"].shape == (256, 8192)
    assert {"dt_norm", "b_norm", "c_norm"} <= set(plan)
    assert "bc_proj" not in plan
    p = init_params(0, {"A_log": ssm.mamba_plan(small_config())["A_log"],
                        "dt_bias": ssm.mamba_plan(small_config())["dt_bias"]},
                    "cpu")
    a = p["A_log"].float()
    assert torch.allclose(torch.exp(a[0]), torch.arange(1.0, 17.0),
                          rtol=1e-2)
    dt = torch.nn.functional.softplus(p["dt_bias"].float())
    assert float(dt.min()) >= 9e-4 and float(dt.max()) <= 0.11


# ------------------------------------------------ 3. and 4. the router

def moe_case(cfg, seed=5):
    p = f32(init_params(seed, moe_mod.moe_plan(cfg), "cpu"))
    return p, Rules.make(MESH, configs.get(ARCH).parallel_for("decode_32k",
                                                              False))


def test_dropless_routing_drops_nothing_under_skew():
    cfg = small_config()
    p, rules = moe_case(cfg)
    # every token's logits rank experts 0 > 1 > the rest
    p["router"] = torch.tensor([2.0, 1.0] + [-1.0] * (cfg.num_experts - 2)
                               ).expand(cfg.d_model, -1).contiguous()
    x = torch.rand(2, 32, cfg.d_model,
                   generator=torch.Generator().manual_seed(8)) + 0.1
    before = dict(vars(moe_mod.DROPLESS))
    moe_mod.DROPLESS.max_load = 0
    with torch.no_grad():
        y, _ = moe_mod.apply_moe(p, x, cfg, rules)
        capped, _ = moe_mod.apply_moe(
            p, x, dataclasses.replace(cfg, capacity_factor=1.25), rules)
    assert moe_mod.DROPLESS.routed - before["routed"] == 2 * 32 * 2
    assert moe_mod.DROPLESS.dropped == before["dropped"]
    assert moe_mod.DROPLESS.max_load == 64
    want = ref_jamba.moe(p, x.reshape(-1, cfg.d_model), cfg)
    assert rel(y.reshape(-1, cfg.d_model), want) <= REL
    assert rel(capped.reshape(-1, cfg.d_model), want) > 0.1


@pytest.mark.parametrize("n_tokens", [1, 2])
def test_dropless_decode_rows_gather_their_experts(n_tokens):
    """No more assignments than experts (a decode step): each assignment's
    expert weights gathered on the device, with no host sync."""
    cfg = small_config()
    p, rules = moe_case(cfg)
    x = torch.randn(1, n_tokens, cfg.d_model,
                    generator=torch.Generator().manual_seed(10))
    before = moe_mod.DROPLESS.routed
    with torch.no_grad():
        y, _ = moe_mod.apply_moe(p, x, cfg, rules)
    assert moe_mod.DROPLESS.routed - before == n_tokens * 2
    assert rel(y[0], ref_jamba.moe(p, x[0], cfg)) <= REL


@pytest.mark.parametrize("norm_topk", [False, True])
def test_gates_are_the_top2_softmax_probabilities(norm_topk):
    cfg = small_config(moe_norm_topk=norm_topk)
    p, rules = moe_case(cfg)
    for name in ("wi_gate", "wi_up", "wo"):         # every expert the same
        p[name] = p[name][:1].expand_as(p[name]).contiguous()
    x = torch.randn(1, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        y, _ = moe_mod.apply_moe(p, x, cfg, rules)
    one = ref_jamba.mlp({k: p[k][0] for k in ("wi_gate", "wi_up", "wo")},
                        x[0])
    probs = torch.softmax(x[0] @ p["router"], dim=-1)
    top2 = torch.topk(probs, 2, dim=-1).values.sum(-1, keepdim=True)
    gates = torch.ones_like(top2) if norm_topk else top2
    assert rel(y[0], gates * one) <= REL
    assert float(top2.max()) < 0.99     # the two cases differ


# ------------------------------------------------ 5. defaults unchanged

#: sha256 (first 16 hex digits) of the train logits, aux loss, prefill
#: logits, decode logits and each cache leaf (sorted by key), parameters
#: `Model.init(5, "cpu")` cast to float32, tokens of seed 11, as the port
#: computed them before the published model's options existed
DIGESTS = {
    "qwen3-moe-30b-a3b": [
        "2cca7227b6f97b58", "803cc823a129cd83", "ffc83664e9c73fb0",
        "432134c23944e261", "8d30495c7f462b02", "62c06241aaa029e8"],
    "jamba-1.5-large-398b": [
        "33aad4e8bfa46a64", "820fff3d2a8089dc", "37e403e94b861d24",
        "0e1912cdd7b47cf1", "241ff656c6898e82", "517e3195e4c76bd8",
        "d7f392e9f8782e54", "2ebafd74c428b9e4", "bdec267a8cd91741",
        "7b39d240c9b7835c"],
}


def digest(t):
    data = t.detach().reshape(-1).contiguous().view(torch.uint8)
    return hashlib.sha256(data.numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("arch", sorted(DIGESTS))
def test_default_options_keep_the_outputs_bit_identical(arch):
    bundle = configs.get(arch)
    model = build(reduced(bundle.model), bundle.parallel_for("decode_32k",
                                                             False))
    params = f32(model.init(5, "cpu"))
    rules = Rules.make(MESH, model.par)
    toks = torch.randint(0, 512, (2, 12),
                         generator=torch.Generator().manual_seed(11))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            lt, _, aux = model.forward(params, {"tokens": toks}, rules,
                                       "train")
            cache = model.init_cache(2, 16, "cpu")
            lp, cache = model.prefill_fn(params, {"tokens": toks}, rules,
                                         cache)
            ld, cache = model.decode_fn(
                params, {"tokens": toks[:, :1], "pos": 12}, cache, rules)
    finally:
        torch.set_num_threads(threads)
    got = [digest(lt), digest(aux), digest(lp), digest(ld)] + [
        digest(cache[k]) for k in sorted(cache)]
    assert got == DIGESTS[arch]


# ------------------------------------------------ 6. parameter counts

@pytest.mark.parametrize("layers,want", [(32, 51.57e9), (8, 13.30e9)])
def test_parameter_counts_on_meta(layers, want):
    bundle = configs.get(ARCH)
    cfg = dataclasses.replace(bundle.model, num_layers=layers)
    model = build(cfg, bundle.parallel_for("decode_32k", False))
    n = sum(t.numel() for t in tree_leaves(model.abstract_params()))
    assert n == cfg.param_count() + cfg.d_model      # + the final norm
    assert abs(n - want) / want < 2e-3
    if layers == 32:
        assert abs(cfg.active_param_count() - 12.11e9) / 12.11e9 < 2e-3


def test_registered_at_the_published_widths():
    cfg = configs.get(ARCH).model
    assert ARCH in configs.published_names()
    assert ARCH not in configs.arch_names()          # the reference's set
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab_size) == (
                32, 4096, 32, 8, 128, 14336, 65536)
    assert (cfg.num_experts, cfg.experts_per_token, cfg.moe_every,
            cfg.moe_offset, cfg.attn_period) == (16, 2, 2, 1, 8)
    assert cfg.attn_layer_indices() == (4, 12, 20, 28)
    assert (cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim,
            cfg.ssm_dt_rank, cfg.ssm_conv_width) == (8192, 16, 256, 4)
    assert cfg.capacity_factor is None and not cfg.moe_norm_topk
    assert cfg.rope_theta == 0
    assert not cfg.tie_embeddings


# ------------------------------------------------ 7. serving

def served(model, params, slots, prompts, max_new=6, spy=None):
    reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    if spy is not None:
        inner = model.prefill_fn

        def prefill_fn(params_, batch, rules, cache):
            spy.append(batch["tokens"].shape[0])
            return inner(params_, batch, rules, cache)
        model = dataclasses.replace(model)
        model.prefill_fn = prefill_fn
    done, _ = serve(model, params, reqs, slots, 40, "cpu")
    return {r.rid: r.generated for r in done}


def test_dropless_moe_prefills_its_own_slot_and_4_slots_give_1_slots_tokens(
        small):
    model, params, _ = small
    prompts = [tokens(16, seed=20 + i).numpy() for i in range(4)]
    rows = []
    four = served(model, params, 4, prompts, spy=rows)
    assert rows == [1, 1, 1, 1]
    one = {}
    for i, p in enumerate(prompts):
        one[i] = served(model, params, 1, [p])[0]
    assert four == one


def test_capacity_routed_moe_keeps_the_broadcast(small):
    model, params, _ = small
    capped = dataclasses.replace(model, cfg=dataclasses.replace(
        model.cfg, capacity_factor=1.25))
    rows = []
    served(capped, params, 4, [tokens(16, seed=30).numpy()], spy=rows)
    assert rows == [4]
