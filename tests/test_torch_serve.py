"""The port's serving launcher (`repro_torch.launch.serve`) and decode example
against the JAX package's, on the CPU.

The reference launcher's ``main`` takes no parameters, so its two closures
(`src/repro/launch/serve.py`: a prefill of one prompt broadcast to every
slot, keeping only the admitted slot's cache rows with ``jnp.where``, and a
decode step at the largest slot position, with zero ``frames`` for the
encoder-decoder) are rebuilt here around the JAX model, with the
reference's batcher.  The port's `serve` must give every request exactly
the tokens they give, in float32 (parameters drawn by the JAX package,
carried over with `params_from_numpy`), more requests than slots, so slots
are reused and a prefill that overwrote another slot's cache would change
its tokens: reduced smollm-135m, qwen3-moe-30b-a3b (whose experts couple
the rows of a prefill: a prefill at B = 1 on the slot's rows gives other
tokens, which a test shows) and whisper-medium.  The reference launcher's
merge takes dim 1 as every leaf's batch axis and fails on jamba's Mamba
leaves, (super-blocks, sublayers, B, …); for jamba-1.5-large-398b the
closures here merge along the axis its cache plan names ``"batch"``.
"""
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
from repro.serve import BatchSlots as JSlots  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.examples import serve_decode  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402

MESH = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
ARCH = "smollm-135m"
REQUESTS, SLOTS, MAX_SEQ, MAX_NEW = 5, 2, 48, 10
#: the other families' archs, served with more slots (4, as the launcher)
FAMILIES = ("qwen3-moe-30b-a3b", "whisper-medium", "jamba-1.5-large-398b")
FAMILY_SLOTS = 4


def _jax_serve(model, params, requests, B: int, S_max: int):
    """The reference launcher's closures around ``model`` and the
    reference's batcher; returns the finished requests and the counters.
    The merge keeps the slot's rows along each leaf's batch axis (dim 1,
    as the launcher's, for every leaf but the hybrid's Mamba leaves)."""
    rules = JRules.make(MESH, model.par)
    cfg = model.cfg
    prefill_one = jax.jit(lambda p, b, c: model.prefill_fn(p, b, rules, c))
    decode = jax.jit(lambda p, b, c: model.decode_fn(p, b, c, rules))
    axes = {k: spec.names.index("batch")
            for k, spec in model.cache_plan(B, S_max).items()}
    with MESH:
        cache_box = {"cache": model.init_cache(B, S_max)}

        def prefill_fn(slot, prompt):
            toks = jnp.broadcast_to(jnp.asarray(prompt)[None],
                                    (B, len(prompt)))
            batch = {"tokens": toks.astype(jnp.int32)}
            if cfg.family == "encdec":
                batch["frames"] = jnp.zeros((B, len(prompt), cfg.d_model))
            logits, new_cache = prefill_one(params, batch, cache_box["cache"])

            def merge(key, new, old):
                ax = axes[key]
                sel = (jnp.arange(B) == slot).reshape(
                    (1,) * ax + (B,) + (1,) * (new.ndim - ax - 1))
                return jnp.where(sel, new, old)

            cache_box["cache"] = {k: merge(k, new_cache[k], v)
                                  for k, v in cache_box["cache"].items()}
            return int(jnp.argmax(logits[slot, -1]))

        def step_fn(tokens, pos):
            batch = {"tokens": jnp.asarray(tokens),
                     "pos": jnp.asarray(int(pos.max()))}
            if cfg.family == "encdec":
                batch["frames"] = jnp.zeros((B, 1, cfg.d_model))
            logits, new_cache = decode(params, batch, cache_box["cache"])
            cache_box["cache"] = new_cache
            return np.asarray(jnp.argmax(logits[:, 0], axis=-1))

        batcher = JBatcher(JSlots(capacity=B, max_seq=S_max), prefill_fn,
                           step_fn)
        for r in requests:
            batcher.submit(r)
        done = batcher.run_until_drained()
    return done, {"steps": batcher.steps, "slot_steps": batcher.slot_steps}


def test_serve_gives_the_reference_launchers_tokens():
    bundle = jconfigs.get(ARCH)
    par = bundle.parallel_for("decode_32k", multi_pod=False)
    jm = jbuild(jreduced(bundle.model), par)
    params = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if a.dtype == jnp.bfloat16 else a,
                          jm.init(jax.random.PRNGKey(0)))
    model = build(reduced(configs.get(ARCH).model), par)
    vocab = model.cfg.vocab_size
    want, want_c = _jax_serve(
        jm, params, launch.draw_requests(REQUESTS, vocab, MAX_NEW), SLOTS,
        MAX_SEQ)
    got, got_c = launch.serve(
        model, params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        launch.draw_requests(REQUESTS, vocab, MAX_NEW), SLOTS, MAX_SEQ,
        device="cpu")
    assert len(got) == len(want) == REQUESTS
    assert {r.rid: r.generated for r in got} == \
        {r.rid: r.generated for r in want}
    assert all(r.done for r in got)
    assert got_c["steps"] == want_c["steps"]
    assert got_c["slot_steps"] == want_c["slot_steps"]
    assert got_c["prefills"] == REQUESTS


def _models(arch: str):
    bundle = jconfigs.get(arch)
    par = bundle.parallel_for("decode_32k", multi_pod=False)
    jm = jbuild(jreduced(bundle.model), par)
    params = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if a.dtype == jnp.bfloat16 else a,
                          jm.init(jax.random.PRNGKey(0)))
    model = build(reduced(configs.get(arch).model), par)
    return jm, params, model, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    arch = request.param
    jm, params, model, tparams = _models(arch)
    vocab = model.cfg.vocab_size
    want, want_c = _jax_serve(
        jm, params, launch.draw_requests(REQUESTS, vocab, MAX_NEW),
        FAMILY_SLOTS, MAX_SEQ)
    return {"arch": arch, "model": model, "params": tparams, "want": want,
            "want_c": want_c}


def test_serve_gives_the_reference_tokens_for_each_family(family):
    model = family["model"]
    got, got_c = launch.serve(
        model, family["params"],
        launch.draw_requests(REQUESTS, model.cfg.vocab_size, MAX_NEW),
        FAMILY_SLOTS, MAX_SEQ, device="cpu")
    assert {r.rid: r.generated for r in got} == \
        {r.rid: r.generated for r in family["want"]}
    assert all(r.done for r in got) and len(got) == REQUESTS
    assert got_c["steps"] == family["want_c"]["steps"]
    assert got_c["slot_steps"] == family["want_c"]["slot_steps"]


def _view_serve(model, params, requests, B: int, S_max: int):
    """`launch.serve` as it would run with a prefill at B = 1 on a view of
    the slot's cache rows for every family (its path for the models without
    experts)."""
    from repro_torch.models.sharding import Rules as TRules
    from repro_torch.serve import BatchSlots, ContinuousBatcher

    rules = TRules.make(launch.MESH, model.par)
    cache = model.init_cache(B, S_max, "cpu")

    def prefill_fn(slot, prompt):
        toks = torch.as_tensor(prompt, dtype=torch.int32)[None]
        view = {k: v[:, slot:slot + 1] for k, v in cache.items()}
        logits, _ = model.prefill_fn(params, {"tokens": toks}, rules, view)
        return int(torch.argmax(logits[0, -1]))

    def step_fn(tokens, pos):
        logits, _ = model.decode_fn(params, {"tokens": torch.as_tensor(
            tokens), "pos": int(pos.max())}, cache, rules)
        return torch.argmax(logits[:, 0], dim=-1).numpy()

    batcher = ContinuousBatcher(BatchSlots(capacity=B, max_seq=S_max),
                                prefill_fn, step_fn)
    for r in requests:
        batcher.submit(r)
    with torch.no_grad():
        return batcher.run_until_drained()


def test_prefill_at_b1_gives_other_tokens_for_the_moe():
    """The experts' capacity counts every row's tokens: the B = 1 view of
    the slot serves other tokens than `serve`'s broadcast prefill, which
    gives the reference's (the previous test)."""
    _, _, model, params = _models("qwen3-moe-30b-a3b")

    def draw():
        return launch.draw_requests(REQUESTS, model.cfg.vocab_size, MAX_NEW)

    want, _ = launch.serve(model, params, draw(), FAMILY_SLOTS, MAX_SEQ,
                           device="cpu")
    got = _view_serve(model, params, draw(), FAMILY_SLOTS, MAX_SEQ)
    assert len(got) == len(want) == REQUESTS
    assert {r.rid: r.generated for r in got} != \
        {r.rid: r.generated for r in want}


def test_draw_requests_is_the_reference_launchers_draw():
    rng = np.random.default_rng(0)
    for r in launch.draw_requests(5, 512, 24):
        plen = int(rng.integers(4, 24))
        np.testing.assert_array_equal(
            r.prompt, rng.integers(0, 512, plen).astype(np.int32))
        assert r.max_new_tokens == int(rng.integers(2, 24))


def test_cli_prints_the_reference_line(capsys):
    launch.main(["--arch", ARCH, "--reduced", "--requests", "3",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("served 3 requests, ")
    assert "decode steps, avg batch occupancy" in out and "/4)" in out


def test_serve_without_a_device_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    model = build(reduced(configs.get(ARCH).model),
                  configs.get(ARCH).parallel_for("decode_32k", False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.serve(model, {}, [], 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", ARCH, "--reduced"])


def test_serve_decode_example(capsys):
    serve_decode.main(ARCH, 4, "cpu")
    out = capsys.readouterr().out
    assert "prefill 4×24 tokens" in out and "decoded 4 tokens × 4 seqs" in out
    assert serve_decode.selftimed(2, 3, 0) == 0
    assert serve_decode.selftimed(2, 3, 1) == 1
    assert "deadlock" in capsys.readouterr().out.lower()
