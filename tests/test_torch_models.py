"""The port's models (`repro_torch.models`, `repro_torch.configs`) against
the JAX package's, on the CPU, at the reduced configs.

Parameters are drawn by the JAX package, cast to float32 and carried over
with `params_from_numpy`; tokens come from a numpy seed.  Each JAX function
is jitted once per (arch, mode) in a module-scoped fixture.

1. For every dense and ssm arch, the port's ``forward`` logits in train,
   prefill and decode mode, its caches after prefill and decode,
   ``prefill_fn``, ``decode_fn`` and ``loss_fn`` equal the JAX package's
   within 1e-5 of the largest logit (of the loss, for the loss) in
   float32.  The JAX side runs its own chunked forms, and so does the port
   on the CPU.  The float32 caches are cast as `tests/test_models.py`
   casts jamba's; int8 KV codes (llama3-405b's serving config) must be
   equal.  In bf16 the train logits are held to `tests/test_models.py`'s
   bar: atol 0.25, rtol 0.1, top-1 agreement ≥ 0.99.
2. The modules that hold a kernel, at the arguments the card path gives
   it: `attention.self_attention`'s kernel call (kernel 5's plain version,
   whose blocks must divide S; the kernel's tiles take any S) equals
   `chunked_attention`, and the time-mix's
   kernel call (kernel 6's plain version at the model's chunk) equals the
   chunked form, S at one chunk and at several.
3. The port's own checks, as the reference's `tests/test_models.py` makes
   them on its own package, with the port's own init (bf16): prefill then
   decode equals the train forward at the last position (llama3-405b with
   int8 KV, rwkv6-1.6b); the rwkv chunked form equals the token-by-token
   recurrence; autograd through ``loss_fn`` gives finite, nonzero
   gradients.
4. `tests/test_sharding_rules.py`'s four cases on the port's `Rules`; the
   configs registry equals the reference's; `build` accepts every
   registered arch, with the reference's parameter, cache and spec plans
   (the moe, hybrid and encoder-decoder families are held to the reference
   in `tests/test_torch_families.py`); `Model.init` without a device
   refuses a host with no card; on the CPU every seed draws other
   parameters, and the seed a CUDA generator gets is unchanged.
"""
import dataclasses
import math
import zlib
from pathlib import Path

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
from repro_torch.configs.base import (ParallelConfig, SHAPE_CELLS,  # noqa: E402
                                      reduced)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.gla_timemix.kernel import gla_timemix  # noqa: E402
from repro_torch.models import Rules, build, rwkv  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

MESH = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
ONE = {"data": 1, "model": 1}
#: the dense and ssm archs (the other families are in
#: tests/test_torch_families.py)
ARCHS = ("smollm-135m", "qwen2-7b", "llama3-405b", "chameleon-34b",
         "command-r-35b", "rwkv6-1.6b")
B, S = 2, 16
REL = 1e-5                      # float32, relative to the largest logit


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(arch: str, cell: str = "decode_32k"):
    bundle = configs.get(arch)
    par = bundle.parallel_for(cell, multi_pod=False)
    return build(reduced(bundle.model), par), Rules.make(ONE, par)


def _rel(want, got, scale=None) -> float:
    want = np.asarray(want, np.float32)
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    assert want.shape == got.shape, (want.shape, got.shape)
    scale = np.abs(want).max() if scale is None else scale
    return float(np.abs(want - got).max() / scale)


@pytest.fixture(scope="module", params=ARCHS)
def parity(request):
    """The JAX package's outputs for one arch, float32 (train, prefill and
    decode forwards, the caches, the loss) and bf16 (the train forward),
    with the port's model and the carried-over parameters."""
    arch = request.param
    bundle = jconfigs.get(arch)
    cfg = jreduced(bundle.model)
    par = bundle.parallel_for("decode_32k", multi_pod=False)
    jm, jr = jbuild(cfg, par), JRules.make(MESH, par)
    params_bf16 = jm.init(jax.random.PRNGKey(1))
    params = _f32(params_bf16)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    with MESH:
        fwd = jax.jit(lambda p, b: jm.forward(p, b, jr, "train")[0])
        train = fwd(params, {"tokens": toks})
        train_bf16 = fwd(params_bf16, {"tokens": toks})
        cache0 = _f32(jm.init_cache(B, S))
        pre_logits, pre_cache, _ = jax.jit(
            lambda p, b, c: jm.forward(p, b, jr, "prefill", c))(
                params, {"tokens": toks[:, :S - 1]}, cache0)
        dec_logits, dec_cache, _ = jax.jit(
            lambda p, b, c: jm.forward(p, b, jr, "decode", c))(
                params, {"tokens": toks[:, S - 1:], "pos": jnp.array(S - 1)},
                pre_cache)
        loss, metrics = jax.jit(lambda p, b: jm.loss_fn(p, b, jr))(
            params, {"tokens": toks})
    model, rules = _port(arch)
    return {
        "arch": arch, "model": model, "rules": rules,
        "toks": torch.from_numpy(toks),
        "params": params_from_numpy(_np(params), "cpu"),
        "params_bf16": params_from_numpy(_np(params_bf16), "cpu"),
        "cache0": _np(cache0), "train": np.asarray(train),
        "train_bf16": np.asarray(train_bf16, np.float32),
        "pre_logits": np.asarray(pre_logits), "pre_cache": _np(pre_cache),
        "dec_logits": np.asarray(dec_logits), "dec_cache": _np(dec_cache),
        "loss": float(loss), "metrics": {k: float(v)
                                         for k, v in metrics.items()}}


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
    m, rules, toks, params = (parity[k] for k in ("model", "rules", "toks",
                                                  "params"))
    train = m.forward(params, {"tokens": toks}, rules, "train")[0]
    assert _rel(parity["train"], train) <= REL
    scale = np.abs(parity["pre_logits"]).max()
    cache = params_from_numpy(parity["cache0"], "cpu")
    pre, cache, _ = m.forward(params, {"tokens": toks[:, :S - 1]}, rules,
                              "prefill", cache)
    assert _rel(parity["pre_logits"], pre, scale) <= REL
    _assert_cache(parity["pre_cache"], cache, "prefill")
    dec, cache, _ = m.forward(params, {"tokens": toks[:, S - 1:],
                                       "pos": S - 1}, rules, "decode", cache)
    assert _rel(parity["dec_logits"], dec) <= REL
    _assert_cache(parity["dec_cache"], cache, "decode")


@torch.no_grad()
def test_prefill_and_decode_fns_match_jax(parity):
    m, rules, toks, params = (parity[k] for k in ("model", "rules", "toks",
                                                  "params"))
    cache = params_from_numpy(parity["cache0"], "cpu")
    last, cache = m.prefill_fn(params, {"tokens": toks[:, :S - 1]}, rules,
                               cache)
    want = parity["pre_logits"][:, -1:]
    assert _rel(want, last) <= REL
    logits, _ = m.decode_fn(params, {"tokens": toks[:, S - 1:],
                                     "pos": torch.tensor(S - 1)}, cache,
                            rules)
    assert _rel(parity["dec_logits"], logits) <= REL


def test_loss_fn_matches_jax_and_has_gradients(parity):
    m, rules, toks = parity["model"], parity["rules"], parity["toks"]
    params = tree_map(lambda a: a.clone().requires_grad_(
        a.is_floating_point()), parity["params"])
    total, metrics = m.loss_fn(params, {"tokens": toks}, rules)
    assert abs(total.item() - parity["loss"]) <= REL * parity["loss"]
    for key, want in parity["metrics"].items():
        assert abs(metrics[key].item() - want) <= REL * max(abs(want), 1.0)
    total.backward()
    grads = [p.grad for p in tree_leaves(params) if p.requires_grad]
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
    assert sum(float(g.square().sum()) for g in grads) > 0


@torch.no_grad()
def test_bf16_forward_matches_jax(parity):
    m, rules, toks = parity["model"], parity["rules"], parity["toks"]
    got = m.forward(parity["params_bf16"], {"tokens": toks}, rules,
                    "train")[0].float().numpy()
    want = parity["train_bf16"]
    np.testing.assert_allclose(got, want, atol=0.25, rtol=0.1)
    assert top1_agreement(want, got) >= 0.99


def top1_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """The share of positions where some token is a top token of both ``a``
    and ``b``.  bf16 logits tie often (at a logit of 2.5 neighbours are
    2**-6 apart), and where a position's largest logit is tied its argmax is
    just the first of the tied ids; two sides agree when they share a top
    token (qwen2-7b's reduced bf16 forward has one such position of 32 in
    the reference's logits, llama3-405b's decode one of 2 in the port's)."""
    top_a = a == a.max(-1, keepdims=True)
    top_b = b == b.max(-1, keepdims=True)
    return float((top_a & top_b).any(-1).mean())


def _inputs(shape, seed, scale=1.0):
    return torch.from_numpy((scale * np.random.default_rng(seed)
                             .standard_normal(shape)).astype(np.float32))


@pytest.mark.parametrize("seq", [16, 13, 192])
def test_attention_kernel_call_computes_chunked_attention(seq):
    """The card path's call of kernel 5, run by its plain version here,
    against the CPU path's `chunked_attention` (reduced qwen2-7b heads)."""
    q = _inputs((1, seq, 4, 16), 0)
    k, v = _inputs((1, seq, 2, 16), 1), _inputs((1, seq, 2, 16), 2)
    blk = math.gcd(seq, 128)
    got = flash_attention(q, k, v, causal=True, bq=blk, bk=blk)
    want = chunked_attention(q, k, v, causal=True)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seq", [16, 130])
def test_timemix_kernel_call_computes_the_chunked_form(seq):
    """The card path's call of kernel 6 at the model's chunk, run by its
    plain version here, against the chunked form from a zero state (one
    chunk at S = 16, five of 26 steps at S = 130)."""
    H, hd = 4, 16
    r, k, v = (_inputs((1, seq, H, hd), i) for i in range(3))
    logw = -torch.exp(_inputs((1, seq, H, hd), 3))
    u = _inputs((H, hd), 4)
    C = rwkv.chunk_size(seq)
    assert seq % C == 0 and (seq == 16) == (C == seq)
    got = gla_timemix(r, k, v, logw, u, chunk=C)
    want, _ = rwkv._chunked(r, k, v, logw, u,
                            torch.zeros((1, H, hd, hd)), C)
    assert torch.allclose(got, want, rtol=2e-3, atol=2e-3)


@torch.no_grad()
@pytest.mark.parametrize("arch", ["llama3-405b", "rwkv6-1.6b"])
def test_decode_matches_own_forward(arch):
    """Prefill to position S−2 then decode S−1 reproduces the train
    forward's logits there (`tests/test_models.py`'s bar in bf16; int8 KV
    adds ~1/127 a K/V element)."""
    m, rules = _port(arch)
    params = m.init(1, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, m.cfg.vocab_size, (B, S)).astype(np.int32))
    full = m.forward(params, {"tokens": toks}, rules, "train")[0]
    cache = m.init_cache(B, S, "cpu")
    _, cache = m.prefill_fn(params, {"tokens": toks[:, :S - 1]}, rules,
                            cache)
    dec, _ = m.decode_fn(params, {"tokens": toks[:, S - 1:], "pos": S - 1},
                         cache, rules)
    a, b = full[:, -1].float().numpy(), dec[:, 0].float().numpy()
    atol = 0.6 if m.par.kv_cache_dtype == "int8" else 0.25
    np.testing.assert_allclose(a, b, atol=atol, rtol=0.1)
    assert top1_agreement(a, b) >= 0.99


@torch.no_grad()
@pytest.mark.parametrize("seq", [12, 130])
def test_rwkv_chunked_equals_stepwise(seq):
    """Chunkwise-parallel time-mix == token-by-token recurrence (one chunk
    at S = 12, as the reference test; five at S = 130)."""
    m, rules = _port("rwkv6-1.6b")
    params = m.init(2, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, m.cfg.vocab_size, (1, seq)).astype(np.int32))
    full = m.forward(params, {"tokens": toks}, rules, "train")[0]
    cache = m.init_cache(1, seq, "cpu")
    steps = []
    for t in range(seq):
        lg, cache = m.decode_fn(params, {"tokens": toks[:, t:t + 1],
                                         "pos": t}, cache, rules)
        steps.append(lg[:, 0])
    got = torch.stack(steps, dim=1).float().numpy()
    np.testing.assert_allclose(got, full.float().numpy(), atol=0.3,
                               rtol=0.1)


# ------------------------------------------ tests/test_sharding_rules.py

def test_spec_basics():
    rules = Rules.make(ONE, ParallelConfig())
    assert rules.spec((16, 32), ("wfsdp", "wtp")) == ("data", "model")
    assert rules.spec((16,), ("norm",)) == (None,)


def test_divisibility_fallback():
    rules = Rules.make(ONE, ParallelConfig())
    rules.mesh = {"data": 16, "model": 16}
    assert rules.spec((9, 64), ("heads", None)) == (None, None)
    assert rules.dropped and rules.dropped[0][0] == "heads"
    assert rules.spec((128, 64), ("heads", None)) == ("model", None)


def test_no_axis_reuse():
    rules = Rules.make({"data": 16, "model": 16},
                       ParallelConfig(fsdp_axes=("data", "model"),
                                      tp_axes=("model",)))
    spec = rules.spec((256, 256), ("wfsdp", "wtp"))
    flat = []
    for part in spec:
        if part is None:
            continue
        flat.extend(part if isinstance(part, tuple) else [part])
    assert len(flat) == len(set(flat))


def test_multi_pod_parallel_defaults():
    b = configs.get("llama3-405b")
    p1 = b.parallel_for("train_4k", multi_pod=False)
    p2 = b.parallel_for("train_4k", multi_pod=True)
    assert "pod" not in p1.batch_axes
    assert p2.batch_axes[0] == "pod"
    assert p2.fsdp_axes[0] == "pod"
    s = configs.get("smollm-135m").parallel_for("train_4k", multi_pod=True)
    assert "pod" in s.fsdp_axes and "pod" not in s.batch_axes


# ----------------------------------------------------- configs and build

def test_configs_equal_the_reference():
    assert configs.arch_names() == jconfigs.arch_names()
    assert {k: dataclasses.asdict(v) for k, v in SHAPE_CELLS.items()} == {
        k: dataclasses.asdict(v)
        for k, v in jconfigs.base.SHAPE_CELLS.items()}
    for arch in configs.arch_names():
        mine, ref = configs.get(arch), jconfigs.get(arch)
        assert dataclasses.asdict(mine.model) == dataclasses.asdict(ref.model)
        assert dataclasses.asdict(reduced(mine.model)) == \
            dataclasses.asdict(jreduced(ref.model))
        assert mine.model.param_count() == ref.model.param_count()
        for cell in list(SHAPE_CELLS) + [""]:
            for pod in (False, True):
                assert dataclasses.asdict(mine.parallel_for(cell, pod)) == \
                    dataclasses.asdict(ref.parallel_for(cell, pod)), \
                    (arch, cell, pod)


def test_plans_and_specs_match_the_reference():
    for arch in ARCHS:
        bundle, ref = configs.get(arch), jconfigs.get(arch)
        par = bundle.parallel_for("decode_32k", False)
        m = build(reduced(bundle.model), par)
        jm = jbuild(jreduced(ref.model), ref.parallel_for("decode_32k",
                                                          False))
        shapes = tree_map(lambda a: tuple(a.shape), m.abstract_params())
        want = jax.tree.map(lambda a: tuple(a.shape), jm.abstract_params())
        assert shapes == want, arch
        cache = tree_map(lambda a: tuple(a.shape), m.abstract_cache(2, 8))
        assert cache == jax.tree.map(lambda a: tuple(a.shape),
                                     jm.abstract_cache(2, 8)), arch
        rules, jrules = Rules.make(ONE, par), JRules.make(MESH, par)
        specs = m.param_specs(rules)
        jspecs = jax.tree.map(tuple, jm.param_specs(jrules),
                              is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))
        assert specs == jspecs, arch


@pytest.mark.parametrize("arch", configs.arch_names())
def test_build_accepts_every_registered_arch(arch):
    """`build` takes every arch of the registry, at full size (a plan, no
    tensors) and reduced, with the reference's shapes, cache shapes and
    parameter specs, and the cache's batch axis where its plan names it."""
    bundle, ref = configs.get(arch), jconfigs.get(arch)
    for cell in ("train_4k", "decode_32k"):
        par = bundle.parallel_for(cell, False)
        jpar = ref.parallel_for(cell, False)
        full = build(bundle.model, par)
        assert tree_map(lambda a: tuple(a.shape), full.abstract_params()) == \
            jax.tree.map(lambda a: tuple(a.shape),
                         jbuild(ref.model, jpar).abstract_params())
        m = build(reduced(bundle.model), par)
        jm = jbuild(jreduced(ref.model), jpar)
        assert tree_map(lambda a: tuple(a.shape), m.abstract_params()) == \
            jax.tree.map(lambda a: tuple(a.shape), jm.abstract_params())
        cache = tree_map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                         m.abstract_cache(3, 8))
        assert cache == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                                     jm.abstract_cache(3, 8)), (arch, cell)
        assert all(cache[k][0][ax] == 3 for k, ax in m.batch_axes().items())
        specs = m.param_specs(Rules.make(ONE, par))
        jspecs = jax.tree.map(tuple, jm.param_specs(JRules.make(MESH, jpar)),
                              is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))
        assert specs == jspecs, (arch, cell)


def test_init_without_a_device_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    m, _ = _port("smollm-135m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(1, 8)


def test_cpu_init_draws_other_parameters_for_every_seed():
    """Reduced jamba-1.5-large-398b on the CPU: seeds 1, 3 and 5 draw three
    different parameter sets (the CPU generator keeps 32 bits of its seed,
    and a seed of ``seed · 2**31 + …`` drew one set for every odd seed),
    one seed draws the same set twice, and the seed a CUDA generator
    receives is what it was."""
    from repro_torch.models.common import leaf_seed

    m, _ = _port("jamba-1.5-large-398b")
    draws = {s: m.init(s, "cpu") for s in (1, 3, 5)}
    for a, b in ((1, 3), (1, 5), (3, 5)):
        assert any(not torch.equal(x, y) for x, y in zip(
            tree_leaves(draws[a]), tree_leaves(draws[b]))), (a, b)
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(draws[3]), tree_leaves(m.init(3, "cpu"))))
    path = "['layers']['attn']['wq']"
    for seed in (0, 1, 3, 2 ** 20 + 7):
        assert leaf_seed(seed, path, "cuda") == (
            seed * 2 ** 31 + zlib.crc32(path.encode()) % 2 ** 31)
        assert 0 <= leaf_seed(seed, path, "cpu") < 2 ** 32
    assert len({leaf_seed(s, path, "cpu") for s in range(64)}) == 64


def test_unit_fan_in_rescales_the_projections(monkeypatch):
    """`chip_smoke.unit_fan_in`, which phase 14 of `chip_smoke.py` applies
    before its float32 comparisons: std 1/sqrt(D) for the stacked
    (L, D, heads, hd) projections, 1/sqrt(heads·hd) for the output ones,
    where the reference's init gives 1/sqrt(heads) and 1/sqrt(hd)."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    from chip_smoke import unit_fan_in

    for arch, key, names in (("qwen2-7b", "attn", ("wq", "wk", "wv")),
                             ("rwkv6-1.6b", "tm", ("wr", "wk", "wv", "wg"))):
        m, _ = _port(arch)
        params = tree_map(lambda a: a.float(), m.init(3, "cpu"))
        layers = params["layers"]
        D = m.cfg.d_model
        before = {n: float(layers[key][n].std()) for n in names + ("wo",)}
        other = "mlp" if key == "attn" else "cm"
        kept = {n: w.clone() for n, w in layers[other].items()}
        unit_fan_in(layers)
        for n in names:
            heads = layers[key][n].shape[-2]
            assert abs(before[n] * heads ** 0.5 - 1) < 0.1, (arch, n)
            assert abs(float(layers[key][n].std()) * D ** 0.5 - 1) < 0.1
        H, hd = layers[key]["wo"].shape[1:3]
        assert abs(float(layers[key]["wo"].std()) * (H * hd) ** 0.5 - 1) < 0.1
        assert all(torch.equal(w, kept[n]) for n, w in layers[other].items())
