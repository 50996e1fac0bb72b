"""The port's training substrate (`repro_torch.data`, `repro_torch.train`,
`repro_torch.launch.train`, `repro_torch.examples.quickstart`) against the
JAX package's, on the CPU, at the reduced configs.

1. The data pipeline: `synthetic_tokens` and `DataPipeline` batches equal
   the reference's bit for bit over several (seed, step), extra features
   included; setting ``step`` rewinds past what the thread prefetched.
2. One train step for reduced smollm-135m and rwkv6-1.6b at m = 2
   microbatches, float32 parameters carried over from the reference with
   `params_from_numpy`, the same numpy tokens.  The reference's jitted
   ``step_fn`` gives the loss and ``grad_norm``; its gradients come from
   ``jax.value_and_grad`` of ``loss_fn`` on its microbatches (rows ≡ i mod
   m), summed in float32 and divided by m, as its step does.  Held, of the
   largest entry of each (leaf by leaf for the gradients): the loss within
   `REL` (the forward's parity bar in ``tests/test_torch_models.py``),
   ``grad_norm`` and every gradient leaf within `GRAD_REL` (backward sums
   in another order, some with cancellation: the largest reading on this
   CPU was 5.2e-5, smollm-135m's attention ``wk``; rwkv6-1.6b's reduced
   gradients have a norm of ~1e8 and read 2.1e-5).  The first AdamW
   step is sign-like (m̂/(√v̂+eps) ≈ ±1 where |g| ≫ eps), so a gradient
   entry near zero whose sign rounds the other way moves its parameter by
   2·lr: the updated parameters are held only where |g| passes
   `CLEAR` of its leaf's largest entry, to `PARAM_ATOL` (a few float32
   units of the parameters' scale, as ``tests/test_torch_optim.py`` holds
   `adamw_update`), against the reference's `adamw_update` on its own
   gradients; the first moments as the gradients, or within one int8
   code.
3. Remat on against remat off (and the two-level remat): equal gradients.
   The kernels' `autograd.Function`s on the CPU (forward: the plain
   versions) give the chunked forms' gradients exactly.
4. Every case of ``tests/test_train_loop.py``,
   ``tests/test_system.py::test_quickstart_trains`` and the two
   ``train.ft`` cases of ``tests/test_resilience.py`` on the port; a crash
   replay gives the uninterrupted run's losses exactly; a resumed run
   names its checkpoints by the global step; the launcher and the
   quickstart run on the CPU.
"""
import dataclasses
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.data.pipeline import DataPipeline as RefPipeline  # noqa: E402
from repro.data.pipeline import synthetic_tokens as ref_tokens  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.sharding import Rules as JRules  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import cosine_warmup as jcosine  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.data import DataPipeline, synthetic_tokens  # noqa: E402
from repro_torch.models import Rules, build  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.quantized import (dequantize_array,  # noqa: E402
                                         quantize_array)
from repro_torch.train.loop import train  # noqa: E402
from repro_torch.train.step import (_accumulated_grads,  # noqa: E402
                                    init_train_state, make_train_step)
from repro_torch.tree import tree_items, tree_leaves, tree_map  # noqa: E402

MESH = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
ONE = {"data": 1, "model": 1}
ARCHS = ("smollm-135m", "rwkv6-1.6b")
B, S, M = 4, 32, 2
LR = 1e-3
REL = 1e-5
GRAD_REL = 2e-4
CLEAR = 1e-2
PARAM_ATOL = 1e-6


def _models(arch: str, **par_kw):
    """The reference's and the port's model at ``arch``'s reduced config
    and ``train_4k`` layout (with ``par_kw``), and their rules."""
    jb, pb = jconfigs.get(arch), configs.get(arch)
    jpar = jb.parallel_for("train_4k", False).replace(**par_kw)
    par = pb.parallel_for("train_4k", False).replace(**par_kw)
    jm = jbuild(jreduced(jb.model), jpar)
    return (jm, JRules.make(MESH, jpar),
            build(reduced(pb.model), par), Rules.make(ONE, par))


def _port(arch: str, **par_kw):
    _, _, model, rules = _models(arch, **par_kw)
    return model, rules


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert want.shape == got.shape
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------- data pipeline

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1),
                                       (123456, 99999)])
def test_synthetic_tokens_equal_the_reference(seed, step):
    np.testing.assert_array_equal(
        synthetic_tokens(seed, step, 3, 17, 49152),
        ref_tokens(seed, step, 3, 17, 49152))


def test_pipeline_batches_equal_the_reference():
    """Four batches from step 5 on through both pipelines; the extra
    features (the encoder-decoder's frames) through both packages' host
    generation, since the reference's device placement of an extra
    feature fails on this JAX (``NamedSharding`` given a tuple)."""
    kw = dict(batch=2, seq=8, vocab=512, seed=11, start_step=5)
    extra = {"frames": ((2, 8, 4), np.float32)}
    ref = RefPipeline(MESH, P(("data", "model")), extra=extra, **kw)
    port = DataPipeline("cpu", extra=extra, **kw)
    try:
        for step in (5, 6, 7, 8):
            want, got = ref._host_batch(step), port._host_batch(step)
            assert set(want) == set(got) == {"tokens", "frames"}
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        ref.close()
        port.close()
    ref = RefPipeline(MESH, P(("data", "model")), **kw)
    port = DataPipeline("cpu", **kw)
    try:
        for _ in range(4):
            want, got = next(ref), next(port)
            assert set(want) == set(got) == {"tokens"}
            assert got["tokens"].dtype == torch.int32
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          np.asarray(want["tokens"]))
        assert port.step == ref.step == 9
        assert port.state_dict() == ref.state_dict()
    finally:
        ref.close()
        port.close()


def test_pipeline_rewind_reads_the_rewound_step():
    """The thread has queued steps ahead; after ``step = 2`` the next batch
    is step 2's, then 3's (the reference's queue would hand out 4's)."""
    pipe = DataPipeline("cpu", batch=2, seq=4, vocab=97, seed=1, prefetch=3)
    try:
        for _ in range(4):
            next(pipe)
        pipe.step = 2
        for want in (2, 3, 4):
            got = next(pipe)["tokens"].numpy()
            np.testing.assert_array_equal(
                got, synthetic_tokens(1, want, 2, 4, 97))
        assert pipe.step == 5
    finally:
        pipe.close()


# ---------------------------------------------------- one step, against JAX

@pytest.fixture(scope="module", params=ARCHS)
def step_parity(request):
    """The reference's step for one arch: its loss and ``grad_norm`` (the
    jitted ``step_fn``, float32 moments), its accumulated gradients, and
    its updated parameters and moments after `adamw_update` on those
    gradients; with the float32 parameters (drawn by the port's init, as
    numpy arrays in both packages) and the tokens."""
    arch = request.param
    jm, jr, model, rules = _models(arch, num_microbatches=M)
    params_np = tree_map(lambda a: a.float().numpy(), model.init(1, "cpu"))
    params = jax.tree.map(jnp.asarray, params_np)
    toks = np.random.default_rng(7).integers(
        0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    lr = float(jcosine(LR, 100, 10000)(jnp.zeros((), jnp.int32)))
    with MESH:
        step = jax.jit(jmake_step(jm, jr, lr=LR).step_fn)
        _, met = step({"params": params, "opt": jadamw_init(params)},
                      {"tokens": toks})
        vg = jax.jit(jax.value_and_grad(
            lambda p, mb: jm.loss_fn(p, mb, jr), has_aux=True))
        grads = None
        for i in range(M):
            _, g = vg(params, {"tokens": toks[i::M]})
            g = jax.tree.map(lambda a: a.astype(jnp.float32), g)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda a: a / M, grads)
        new_p, new_opt, _ = jax.jit(jadamw_update)(
            params, grads, jadamw_init(params), lr)
    return {"arch": arch, "model": model, "rules": rules,
            "params": params_from_numpy(params_np, "cpu"),
            "toks": torch.from_numpy(toks),
            "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
            "grads": jax.tree.map(np.asarray, grads),
            "new_params": jax.tree.map(np.asarray, new_p),
            "new_m": jax.tree.map(np.asarray, new_opt["m"])}


def _clear(grads_np):
    """Per leaf: where |g| passes `CLEAR` of the leaf's largest entry."""
    return {k: np.abs(g) > CLEAR * np.abs(g).max()
            for k, g in tree_items(grads_np)}


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_train_step_matches_jax(step_parity, state_dtype):
    """The port's whole step: loss and ``grad_norm`` against the
    reference's step, the updated parameters (where the gradient is clear)
    and the first moments against the reference's `adamw_update` of its
    own gradients.  From zero moments the first step's update does not
    depend on how the moments are stored (zero int8 codes dequantize to
    exact zeros), so the int8 step is held to the same parameters, and its
    moments' codes within one of the reference's float32 moments quantized
    (`quantize_array`, held to the reference's in
    ``tests/test_torch_optim.py``), as the reference's int8 step stores
    them."""
    p = step_parity
    model = build(p["model"].cfg, p["model"].par.replace(
        optimizer_state_dtype=state_dtype))
    bundle = make_train_step(model, p["rules"], lr=LR)
    state = {"params": p["params"],
             "opt": adamw_init(p["params"], state_dtype)}
    new, met = bundle.step_fn(state, {"tokens": p["toks"]})
    assert abs(met["loss"].item() - p["loss"]) <= REL * p["loss"]
    assert abs(met["grad_norm"].item() - p["grad_norm"]) \
        <= GRAD_REL * p["grad_norm"]
    assert int(met["step"]) == 1 and int(new["opt"]["step"]) == 1
    clear = _clear(p["grads"])
    got = dict(tree_items(new["params"]))
    got_m = dict(tree_items(new["opt"]["m"]))
    for k, w in tree_items(p["new_params"]):
        diff = np.abs(got[k].numpy() - w)[clear[k]]
        assert diff.size and diff.max() <= PARAM_ATOL, (k, diff.max())
    for k, w in tree_items(p["new_m"]):
        bar = GRAD_REL * np.abs(w).max()
        if state_dtype == "float32":
            assert np.abs(got_m[k].numpy() - w).max() <= bar, k
            continue
        # the reference's int8 step quantizes these float32 moments
        want = quantize_array(torch.from_numpy(np.array(w)))
        q, scale = got_m[k + "['q']"], got_m[k + "['scale']"]
        assert int((q.int() - want["q"].int()).abs().max()) <= 1, k
        assert float((scale - want["scale"]).abs().max()) <= bar / 127, k


def test_accumulated_gradients_match_jax(step_parity):
    p = step_parity
    grads, loss = _accumulated_grads(p["model"], p["rules"], p["params"],
                                     {"tokens": p["toks"]})
    assert abs(loss.item() - p["loss"]) <= REL * p["loss"]
    got = dict(tree_items(grads))
    for k, want in tree_items(p["grads"]):
        assert got[k].dtype == torch.float32
        assert _rel(want, got[k]) <= GRAD_REL, k


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_train_state_layout_matches_the_reference(state_dtype):
    """The bundle's state specs and the abstract train state (what a
    checkpoint restore reads) equal the reference's, at a 2 x 2 mesh so
    the divisibility fallback acts."""
    from repro.train.step import make_abstract_train_state as jabstract
    from repro_torch.train.step import make_abstract_train_state

    jm, _, model, _ = _models("qwen2-7b", optimizer_state_dtype=state_dtype)
    mesh = Mesh(np.array(jax.devices() * 4).reshape(2, 2), ("data", "model"))
    jr = JRules.make(mesh, jm.par)
    rules = Rules.make({"data": 2, "model": 2}, model.par)
    want = jax.tree.map(tuple, jmake_step(jm, jr).state_specs,
                        is_leaf=lambda x: isinstance(x, P))
    assert make_train_step(model, rules).state_specs == want
    assert tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                    make_abstract_train_state(model)) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), jabstract(jm))


# ----------------------------------------------------------------- remat

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_gradients_of_no_remat(arch):
    """Four layers: no remat, one checkpoint a layer, and blocks of two
    layers around them (the reference's two-level remat)."""
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (2, 16)).astype(np.int32))
    got = {}
    for remat, block in (("none", 0), ("full", 0), ("full", 2)):
        bundle = configs.get(arch)
        par = bundle.parallel_for("train_4k", False).replace(
            remat=remat, remat_block=block)
        model = build(dataclasses.replace(reduced(bundle.model),
                                          num_layers=4), par)
        params = tree_map(lambda a: a.float().requires_grad_(),
                          model.init(3, "cpu"))
        total, _ = model.loss_fn(params, {"tokens": toks},
                                 Rules.make(ONE, par))
        got[(remat, block)] = torch.autograd.grad(total,
                                                  tree_leaves(params))
    base = got.pop(("none", 0))
    for key, grads in got.items():
        for a, b in zip(grads, base):
            assert torch.allclose(a, b, rtol=0, atol=1e-6 * float(
                b.abs().max())), key


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_gives_chunked_gradients(causal):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import chunked_attention

    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_() for s in ((2, 64, 4, 16), (2, 64, 2, 16),
                                           (2, 64, 2, 16)))
    g = torch.from_numpy(rng.standard_normal((2, 64, 4, 16))
                         .astype(np.float32))
    out = flash_attention(q, k, v, causal=causal, bq=32, bk=32)
    assert out.grad_fn is not None
    want = torch.autograd.grad(chunked_attention(q, k, v, causal=causal),
                               (q, k, v), g)
    for a, b in zip(torch.autograd.grad(out, (q, k, v), g), want):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert flash_attention(q, k, v, causal=causal,
                               bq=32, bk=32).grad_fn is None
    with pytest.raises(ValueError, match="scale"):
        flash_attention(q, k, v, causal=causal, bq=32, bk=32, scale=0.5)


def test_gla_function_gives_chunked_gradients():
    from repro_torch.kernels.gla_timemix.kernel import (gla_timemix,
                                                        timemix_from_zero)

    rng = np.random.default_rng(5)

    def draw(shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32))

    r, k, v = (draw((1, 48, 2, 16)).requires_grad_() for _ in range(3))
    logw = (-torch.exp(draw((1, 48, 2, 16), 0.5))).requires_grad_()
    u = draw((2, 16)).requires_grad_()
    ins = (r, k, v, logw, u)
    g = draw((1, 48, 2, 16))
    out = gla_timemix(*ins, chunk=16)
    assert out.grad_fn is not None
    want = torch.autograd.grad(timemix_from_zero(*ins, 16), ins, g)
    for a, b in zip(torch.autograd.grad(out, ins, g), want):
        assert torch.equal(a, b)


# ------------------------------------------- tests/test_train_loop.py cases

def test_loss_decreases(tmp_path):
    model, rules = _port("smollm-135m", num_microbatches=2)
    rep = train(model, rules, steps=100, ckpt_dir=str(tmp_path), lr=2e-2,
                ckpt_every=1000, device="cpu")
    assert rep.steps_run == 100
    # uniform synthetic tokens: the learnable margin is init-noise → ln(V)
    # (6.30 → 6.24); demand a consistent decrease toward the entropy floor
    assert np.mean(rep.losses[-10:]) < np.mean(rep.losses[:10]) - 0.03


def test_crash_replay_resumes(tmp_path):
    model, rules = _port("smollm-135m", num_microbatches=2)
    rep = train(model, rules, steps=12, ckpt_dir=str(tmp_path), lr=1e-3,
                ckpt_every=5, fail_at=7, device="cpu")
    # injected fault at step 7 → restore from ckpt 5 and replay to 12
    assert rep.steps_run == 12
    assert np.isfinite(rep.final_loss)


def test_crash_replay_equals_the_uninterrupted_run(tmp_path):
    """The replay restores step 5's state and reads step 5's batch again:
    every loss equals the run without a fault (the CPU is deterministic)."""
    model, rules = _port("rwkv6-1.6b", num_microbatches=2)
    plain = train(model, rules, steps=9, ckpt_dir=str(tmp_path / "a"),
                  lr=1e-3, ckpt_every=5, device="cpu")
    hit = train(model, rules, steps=9, ckpt_dir=str(tmp_path / "b"),
                lr=1e-3, ckpt_every=5, fail_at=7, device="cpu")
    assert len(hit.losses) == len(plain.losses) == 9
    assert hit.losses == plain.losses


def test_resume_from_checkpoint_continues(tmp_path):
    model, rules = _port("smollm-135m", num_microbatches=2)
    train(model, rules, steps=6, ckpt_dir=str(tmp_path), ckpt_every=3,
          device="cpu")
    rep2 = train(model, rules, steps=4, ckpt_dir=str(tmp_path),
                 ckpt_every=100, device="cpu")
    assert rep2.restored_from == 6
    # the port names a resumed run's checkpoints by the global step
    from repro_torch.checkpoint import CheckpointManager
    assert CheckpointManager(str(tmp_path)).all_steps() == [3, 6, 10]


def test_int8_quantize_roundtrip():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(7, 300)).astype(np.float32))
    back = dequantize_array(quantize_array(x), x.shape)
    err = float((back - x).abs().max())
    assert err <= float(x.abs().max()) / 127 + 1e-6


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_step_moves_params(state_dtype):
    params = {"w": torch.ones((4, 300)), "b": torch.zeros((3,))}
    grads = {"w": torch.full((4, 300), 0.1), "b": torch.full((3,), -0.2)}
    opt = adamw_init(params, state_dtype)
    new_p, new_opt, gnorm = adamw_update(params, grads, opt, 1e-2,
                                         state_dtype=state_dtype)
    assert float(gnorm) > 0
    assert not torch.allclose(new_p["w"], params["w"])
    assert int(new_opt["step"]) == 1


def test_chunked_update_matches_unchunked():
    """The sliced optimizer path must equal the direct path."""
    rng = np.random.default_rng(1)
    big = torch.from_numpy(rng.normal(size=(4, 64, 17000)).astype(np.float32))
    grads = torch.from_numpy(rng.normal(size=big.shape)
                             .astype(np.float32)) * 0.01
    p1 = {"w": big}
    n1, _, _ = adamw_update(p1, {"w": grads}, adamw_init(p1), 1e-3,
                            chunk_threshold=1 << 20)
    # force the unchunked path via a reshaped view (leading dim 1)
    p2r = {"w": big.reshape(1, -1)}
    n2, _, _ = adamw_update(p2r, {"w": grads.reshape(1, -1)},
                            adamw_init(p2r), 1e-3)
    assert torch.allclose(n1["w"].ravel(), n2["w"].ravel(), rtol=0,
                          atol=1e-6)


def test_watchdog_and_preemption():
    from repro_torch.train.ft import PreemptionGuard, StepWatchdog
    wd = StepWatchdog(threshold=2.0)
    assert not wd.observe(0, 1.0)
    assert not wd.observe(1, 1.1)
    assert wd.observe(2, 5.0)            # straggler
    assert wd.stragglers == [2]
    g = PreemptionGuard(signals=())
    assert not g.should_exit


# ----------------------------- tests/test_resilience.py (train.ft cases)

def test_preemption_guard_is_a_context_manager():
    from repro_torch.train.ft import PreemptionGuard
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.should_exit
        guard._handler(signal.SIGTERM, None)
        assert guard.should_exit
    assert signal.getsignal(signal.SIGTERM) is before


def test_retrying_backoff_is_bounded_and_capped():
    from repro_torch.train.ft import retrying
    calls, waits, restores = [], [], []

    def fn():
        calls.append(1)
        raise RuntimeError("flaky")
    wrapped = retrying(fn, lambda: restores.append(1), max_retries=3,
                       backoff=0.5, max_backoff=1.0, sleep=waits.append)
    with pytest.raises(RuntimeError):
        wrapped()
    assert len(calls) == 4                # the cap is hard
    assert len(restores) == 3
    assert waits == [0.5, 1.0, 1.0]       # exponential, then clamped


# ------------------------------ tests/test_system.py, the launcher, examples

def test_quickstart_trains():
    """The quickstart's path: a ~100M-family model (reduced) trains for a
    few steps on one batch and the loss moves."""
    model, rules = _port("smollm-135m", num_microbatches=2)
    bundle_t = make_train_step(model, rules, lr=5e-3)
    state = init_train_state(model, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(100).integers(
        0, model.cfg.vocab_size, (4, 64)).astype(np.int32))
    losses = []
    for _ in range(8):
        state, metrics = bundle_t.step_fn(state, {"tokens": toks})
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]          # same batch → loss must drop


def test_quickstart_example_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples.quickstart import main
    rep = main(["--device", "cpu", "--steps", "3", "--validate",
                "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "12 channels operationally confirmed" in out
    assert rep.steps_run == 3 and np.isfinite(rep.final_loss)


def test_launcher_trains_reduced_and_refuses_distributed(tmp_path, capsys,
                                                          monkeypatch):
    """``--distributed`` joins the job the environment names (here a world
    of one gloo rank) and refuses it: the full config trains on the
    production mesh of 256 cards."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.train import main
    main(["--arch", "rwkv6-1.6b", "--reduced", "--steps", "2", "--ckpt",
          str(tmp_path), "--device", "cpu"])
    assert "steps=2 " in capsys.readouterr().out
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                     RANK="0", WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="world of 1 ranks does not match "
                       "the mesh .* of 256 cards"):
        main(["--arch", "smollm-135m", "--distributed", "--device", "cpu"])
    assert not dist.is_initialized()


def test_train_without_a_device_refuses_a_host_without_a_card(tmp_path,
                                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, rules = _port("smollm-135m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(model, rules, steps=1, ckpt_dir=str(tmp_path))
