"""The port's MoE, hybrid and encoder-decoder families against the JAX
package's, on the CPU, at the reduced configs.

qwen3-moe-30b-a3b and dbrx-132b (moe), jamba-1.5-large-398b (hybrid: two
super-blocks of one attention and three Mamba sublayers, MoE on every second
sublayer, int8 KV in its serving config) and whisper-medium (encdec, with
``frames``).  Parameters are drawn by the JAX package, cast to float32 and
carried over with `params_from_numpy`; tokens and frames come from a numpy
seed.  Each JAX function is jitted once per (arch, mode) in a module-scoped
fixture.

The reference's init takes the head count as the fan-in of the stacked
(D, heads, hd) projections, so at the reduced width q and k have an RMS of
about 4 and the scores of about 16, and the softmax amplifies a float32
rounding difference between two correct paths: one whisper encoder
attention reads 1.3e-7 of its largest output on equal inputs and 1.0e-6 on
inputs one layernorm rounding apart.  Over whisper's six attentions and
jamba's eight sublayers the train logits read 1.5e-5 and 4.1e-5 of the
largest, and the gradients up to 2.6e-4 (whisper) of a leaf's largest
entry, at the reference's init; with ``wq`` and ``wk`` scaled by
`QK_SCALE` (scores 1/16 as large) they read 4.2e-7 and 2.8e-6, and every
gradient at most 8.0e-6 (jamba's router).  So the comparisons below run
at that scale, and the train logits at the reference's init are held to
`REF_INIT_REL`.

1. The port's ``forward`` logits in train, prefill and decode mode, its
   caches after prefill and decode, ``prefill_fn``, ``decode_fn`` and
   ``loss_fn`` (with the MoE aux loss) equal the JAX package's within 1e-5
   of the largest logit (of the loss, for the loss), as
   `tests/test_torch_models.py` holds the dense and ssm families; int8 KV
   codes must be equal.  In bf16 the train logits of the moe and encdec
   archs are held to its bar (atol 0.25, rtol 0.1, top-1 agreement ≥
   0.99), at the reference's init; jamba runs in float32 only, as
   `tests/test_models.py` runs it (its random bf16 stack is chaotic).
   The float32 train logits at the reference's init are held to
   `REF_INIT_REL`.
2. Gradients of ``loss_fn`` with respect to every parameter equal
   ``jax.grad``'s within `GRAD_REL` = 1e-5 of each leaf's largest entry,
   jamba's too.
3. The port's own check, as `tests/test_models.py` makes it: prefill then
   decode equals the train forward at the last position (capacity factor 8,
   so no token is dropped at either length), bf16 at its bar.  jamba runs
   in float32 with the KV cache in float32, at its float32 bar (atol 1e-4,
   rtol 0.1): with its serving config's int8 KV the quantization, amplified
   by the scores, reads 0.08–0.14 at the draws tried, against a bar of
   0.05 calibrated on one draw; the int8 codes are held to the reference's
   in 1.
4. A train forward calls `attention.self_attention` (kernel 5 on the card,
   its plain form here) once an attention layer: the decoder layers, the
   hybrid's one a super-block, and whisper's encoder layers non-causally.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.sharding import Rules as JRules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.models import Rules, build  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.tree import tree_items, tree_map  # noqa: E402

MESH = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
ONE = {"data": 1, "model": 1}
ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b", "jamba-1.5-large-398b",
         "whisper-medium")
B, S = 2, 16
REL = 1e-5                      # float32, relative to the largest logit
GRAD_REL = 1e-5                 # of each leaf's largest gradient entry
#: the factor on ``wq`` and ``wk`` of every attention (see the docstring)
QK_SCALE = 0.25
#: the float32 train logits at the reference's init, of the largest logit:
#: 2.5 times the largest reading (jamba's 4.1e-5)
REF_INIT_REL = 1e-4


def _qk_scaled(tree):
    """A copy of a numpy parameter tree with every ``wq`` and ``wk`` times
    `QK_SCALE`."""
    return {k: _qk_scaled(v) if isinstance(v, dict)
            else v * np.float32(QK_SCALE) if k in ("wq", "wk") else v
            for k, v in tree.items()}


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _frames(cfg, n: int, seed: int = 6):
    return np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)


def _batches(cfg, toks):
    """The train, prefill and decode batches (with frames for whisper, as
    `tests/test_models.py` passes them)."""
    train = {"tokens": toks}
    pre = {"tokens": toks[:, :S - 1]}
    dec = {"tokens": toks[:, S - 1:]}
    if cfg.family == "encdec":
        frames = _frames(cfg, S)
        train["frames"] = pre["frames"] = frames
        dec["frames"] = frames[:, :1]
    return train, pre, dec


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def parity(request):
    arch = request.param
    bundle = jconfigs.get(arch)
    cfg = jreduced(bundle.model)
    par = bundle.parallel_for("decode_32k", multi_pod=False)
    jm, jr = jbuild(cfg, par), JRules.make(MESH, par)
    params_bf16 = jm.init(jax.random.PRNGKey(1))
    params_ref = _np(_f32(params_bf16))
    params = _qk_scaled(params_ref)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    train, pre, dec = _batches(cfg, toks)
    with MESH:
        fwd = jax.jit(lambda p, b: jm.forward(p, b, jr, "train")[0])
        want = {"train": fwd(params, train),
                "train_ref_init": fwd(params_ref, train)}
        if cfg.family != "hybrid":
            want["train_bf16"] = np.asarray(fwd(params_bf16, train),
                                            np.float32)
        cache0 = _f32(jm.init_cache(B, S))
        pre_logits, pre_cache, _ = jax.jit(
            lambda p, b, c: jm.forward(p, b, jr, "prefill", c))(
                params, pre, cache0)
        dec_logits, dec_cache, _ = jax.jit(
            lambda p, b, c: jm.forward(p, b, jr, "decode", c))(
                params, dict(dec, pos=jnp.array(S - 1)), pre_cache)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss_fn(p, b, jr), has_aux=True))(params, train)
    model = build(reduced(configs.get(arch).model), par)
    return {
        "arch": arch, "model": model, "rules": Rules.make(ONE, par),
        "batches": [_torch_batch(b) for b in (train, pre, dec)],
        "params": params_from_numpy(params, "cpu"),
        "params_ref": params_from_numpy(params_ref, "cpu"),
        "params_bf16": params_from_numpy(_np(params_bf16), "cpu"),
        "cache0": _np(cache0), "want": _np(want),
        "pre_logits": np.asarray(pre_logits), "pre_cache": _np(pre_cache),
        "dec_logits": np.asarray(dec_logits), "dec_cache": _np(dec_cache),
        "loss": float(loss), "metrics": {k: float(v)
                                         for k, v in metrics.items()},
        "grads": dict(tree_items(_np(grads)))}


def _rel(want, got, scale=None) -> float:
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    assert want.shape == got.shape, (want.shape, got.shape)
    scale = np.abs(want).max() if scale is None else scale
    return float(np.abs(want - got).max() / max(scale, 1e-30))


def _assert_cache(want: dict, got: dict, what: str) -> None:
    assert set(want) == set(got), what
    for key in want:
        w = np.asarray(want[key])
        if w.dtype == np.int8:
            np.testing.assert_array_equal(got[key].numpy(), w,
                                          err_msg=f"{what} {key}")
        else:
            scale = max(float(np.abs(w.astype(np.float32)).max()), 1e-30)
            assert _rel(w, got[key], scale) <= REL, (what, key)


@torch.no_grad()
def test_forward_modes_match_jax(parity):
    m, rules, params = parity["model"], parity["rules"], parity["params"]
    train, pre, dec = parity["batches"]
    logits, _, aux = m.forward(params, train, rules, "train")
    assert _rel(parity["want"]["train"], logits) <= REL
    scale = np.abs(parity["pre_logits"]).max()
    cache = params_from_numpy(parity["cache0"], "cpu")
    got, cache, _ = m.forward(params, pre, rules, "prefill", cache)
    assert _rel(parity["pre_logits"], got, scale) <= REL
    _assert_cache(parity["pre_cache"], cache, "prefill")
    got, cache, _ = m.forward(params, dict(dec, pos=S - 1), rules, "decode",
                              cache)
    assert _rel(parity["dec_logits"], got) <= REL
    _assert_cache(parity["dec_cache"], cache, "decode")


@torch.no_grad()
def test_prefill_and_decode_fns_match_jax(parity):
    m, rules, params = parity["model"], parity["rules"], parity["params"]
    _, pre, dec = parity["batches"]
    cache = params_from_numpy(parity["cache0"], "cpu")
    last, cache = m.prefill_fn(params, pre, rules, cache)
    assert _rel(parity["pre_logits"][:, -1:], last) <= REL
    logits, _ = m.decode_fn(params, dict(dec, pos=torch.tensor(S - 1)),
                            cache, rules)
    assert _rel(parity["dec_logits"], logits) <= REL


def test_loss_fn_and_gradients_match_jax(parity):
    m, rules = parity["model"], parity["rules"]
    params = tree_map(lambda a: a.clone().requires_grad_(
        a.is_floating_point()), parity["params"])
    total, metrics = m.loss_fn(params, parity["batches"][0], rules)
    assert abs(total.item() - parity["loss"]) <= REL * parity["loss"]
    for key, want in parity["metrics"].items():
        assert abs(metrics[key].item() - want) <= REL * max(abs(want), 1.0)
    if m.cfg.num_experts:
        assert metrics["aux"].item() > 0
    total.backward()
    got = dict(tree_items(params))
    assert set(got) == set(parity["grads"])
    missing = [k for k, p in got.items() if p.grad is None]
    assert not missing, missing
    errs = {k: _rel(w, got[k].grad) for k, w in parity["grads"].items()}
    assert max(errs.values()) <= GRAD_REL, sorted(errs.items(),
                                                  key=lambda kv: -kv[1])[:5]


@torch.no_grad()
def test_forward_at_the_reference_init_matches_jax(parity):
    m, rules = parity["model"], parity["rules"]
    got = m.forward(parity["params_ref"], parity["batches"][0], rules,
                    "train")[0]
    assert _rel(parity["want"]["train_ref_init"], got) <= REF_INIT_REL


@torch.no_grad()
def test_bf16_forward_matches_jax(parity):
    if "train_bf16" not in parity["want"]:
        pytest.skip("jamba is compared in float32 only (its random bf16 "
                    "stack is chaotic, tests/test_models.py)")
    m, rules = parity["model"], parity["rules"]
    got = m.forward(parity["params_bf16"], parity["batches"][0], rules,
                    "train")[0].float().numpy()
    want = parity["want"]["train_bf16"]
    np.testing.assert_allclose(got, want, atol=0.25, rtol=0.1)
    top_a = want == want.max(-1, keepdims=True)
    top_b = got == got.max(-1, keepdims=True)
    assert float((top_a & top_b).any(-1).mean()) >= 0.99


@torch.no_grad()
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """Prefill S − 1 tokens, decode token S: the train forward's logits at
    S − 1, with no token dropped (capacity factor 8, as the reference's
    test sets it).  bf16 at `tests/test_models.py`'s bar, jamba in float32
    at its int8-KV bar."""
    bundle = configs.get(arch)
    cfg = reduced(bundle.model)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    par = bundle.parallel_for("decode_32k", multi_pod=False)
    hybrid = cfg.family == "hybrid"
    if hybrid:
        par = par.replace(kv_cache_dtype="bfloat16")
    m = build(cfg, par)
    rules = Rules.make(ONE, m.par)
    params = m.init(1, "cpu")
    if hybrid:
        params = tree_map(lambda a: a.float(), params)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    train, pre, dec = (_torch_batch(b) for b in _batches(cfg, toks))
    full = m.forward(params, train, rules, "train")[0]
    cache = m.init_cache(B, S, "cpu")
    if hybrid:
        cache = {k: v.float() if v.is_floating_point() else v
                 for k, v in cache.items()}
    _, cache = m.prefill_fn(params, pre, rules, cache)
    got, _ = m.decode_fn(params, dict(dec, pos=S - 1), cache, rules)
    a, b = full[:, -1].float().numpy(), got[:, 0].float().numpy()
    if hybrid:
        atol = 1e-4
    else:
        atol = 0.6 if m.par.kv_cache_dtype == "int8" else 0.25
    np.testing.assert_allclose(a, b, atol=atol, rtol=0.1)
    assert float(((a == a.max(-1, keepdims=True))
                  & (b == b.max(-1, keepdims=True))).any(-1).mean()) >= 0.99


@torch.no_grad()
def test_train_forward_calls_kernel_5_once_an_attention_layer(parity,
                                                               monkeypatch):
    m, rules, params = parity["model"], parity["rules"], parity["params"]
    calls = []
    plain = attention_mod.self_attention

    def counted(q, k, v, causal=True):
        calls.append(causal)
        return plain(q, k, v, causal=causal)

    monkeypatch.setattr(attention_mod, "self_attention", counted)
    m.forward(params, parity["batches"][0], rules, "train")
    cfg = m.cfg
    if cfg.family == "encdec":
        assert calls == [False] * cfg.encoder_layers + [True] * cfg.num_layers
    elif cfg.family == "hybrid":
        assert calls == [True] * (cfg.num_layers // cfg.attn_period)
    else:
        assert calls == [True] * cfg.num_layers
