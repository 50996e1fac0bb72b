"""The port's sharded execution (`Rules` on a `DeviceMesh`, every tensor a
DTensor) on four gloo ranks in a 2×2 ``("data", "model")`` mesh, against the
JAX package on a 2×2 host mesh and against the port's one-device path.

Parameters are drawn here by the port's init on the CPU from each case's
seed, cast to float32, and cross over to both packages as numpy arrays (the
port's through `params_from_numpy`); tokens and frames come from numpy
seeds.
The reference runs once, in one subprocess with four host devices on a
mesh whose axes are ``Auto`` (JAX 0.9.0 refuses ``with_sharding_constraint``
on explicit axes, ROADMAP.md §3); the port runs once, in one spawn of four
ranks (`tests/torch_ranks.py::mesh_rank`), at the same time.  Cases:

* serve layout: reduced qwen2-7b at ``decode_32k`` (qwen2-7b's ``""``
  entry: heads, MLP and vocabulary on ``model``, batch and FSDP on
  ``data``, the cache's positions on ``model``): the prefill logits of 15
  tokens at B = 4 and four greedy decode steps, against the reference at
  `tests/test_torch_families.py`'s float32 bar (atol 1e-4, rtol 0.1) and
  against the port's one-device run; the tokens equal.  `serve` itself on
  the mesh gives the one-device server's tokens.
* train layout: reduced qwen2-7b at ``train_4k`` (FSDP and DP over
  ``("data", "model")``): the loss within `REL` = 1e-5, every gradient
  within `GRAD_REL` = 2e-4 of its leaf's largest entry (the bars of
  `tests/test_torch_train.py`), and each rank's parameters after one AdamW
  step within `PARAM_ATOL` = 1e-6 (`tests/test_torch_train.py`'s bar)
  wherever the rank's gradient entry is above `GRAD_CLEAR` = 1e-2 of its
  leaf's largest, and elsewhere within 2 lr.  A first step moves every
  entry by lr·g / (|g| + 1e-8) after the clip: where g is large that is
  lr·sign(g), and a gradient whose shards are summed in another order
  (within 1e-5 of the leaf's largest here) moves it by nothing visible;
  but an entry that cancels to near zero carries that rounding as a large
  part of itself, and near 1e-8 after the clip it moves the step by a part
  of lr (up to 2.3e-4 at lr = 1e-2 here, at 17 of ``bk``'s 64 entries,
  whose gradient is near zero throughout), and by at most 2 lr.
* two AdamW steps with int8 moments on a parameter whose last dimension
  the mesh splits into blocks that are not whole 256s: the codes, scales
  and parameters equal the one-device step's (the dimension is gathered,
  so the blocks are the global ones, as the reference's).
* the MoE combine across expert shards: reduced qwen3-moe-30b-a3b's loss
  and aux loss (two groups, the capacity's overflow included) within
  `REL`.
* rwkv6-1.6b, jamba-1.5-large-398b (Mamba, MoE) and whisper-medium: the
  train forward's logits within `REL` of the largest, with ``wq`` and
  ``wk`` of jamba's and whisper's attentions scaled as
  `tests/test_torch_families.py` scales them.
* each rank's block of every parameter, after `Model.distribute` (equal)
  and after the step (within those bars), against the reference device's
  ``addressable_shards`` at the same (data, model) coordinate, shape and
  contents; a ``"wtp2"`` = ``("model", "data")`` leaf is numbered model-major
  as JAX numbers it; ``rules.dropped`` equals the reference's.
* a checkpoint saved on 2×2 restores on 1×4 and on one device to equal
  parameters; a resumed run and a run through an injected fault give an
  uninterrupted run's losses.
* negative cases: a plain tensor into `Rules.constrain` on the mesh, and a
  world that is not the production mesh's size under ``launch.train
  --distributed``, both refused.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_ranks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.comm import run_ranks  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.launch.serve import draw_requests, serve  # noqa: E402
from repro_torch.models import Rules, build  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CASES = torch_ranks.MESH_CASES
REL = 1e-5
GRAD_REL = 2e-4
PARAM_ATOL = 1e-6
GRAD_CLEAR = 1e-2
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 0.1
QK_SCALE = 0.25                 # tests/test_torch_families.py's

_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.configs.base import reduced
    from repro.models import build
    from repro.models.sharding import Rules
    from repro.train.step import make_train_step

    cases = json.loads(sys.argv[3])
    data = dict(np.load(sys.argv[1]))
    out = {}
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)

    def unflat(prefix):
        tree = {}
        for k, v in data.items():
            if not k.startswith(prefix):
                continue
            node, keys = tree, eval("[" + k[len(prefix):].replace(
                "][", "],[") + "]")
            for key in [kk[0] for kk in keys[:-1]]:
                node = node.setdefault(key, {})
            node[keys[-1][0]] = jnp.asarray(v)
        return tree

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}[{k!r}]")
        else:
            yield prefix, tree

    def shards(name, tree):
        for path, a in flat(tree, ""):
            for sh in a.addressable_shards:
                i, j = np.argwhere(mesh.devices == sh.device)[0]
                out[f"{name}/shard{path}@{i}{j}"] = np.asarray(sh.data)

    def setup(case):
        arch, cell, _ = cases[case]
        bundle = configs.get(arch)
        model = build(reduced(bundle.model), bundle.parallel_for(cell, False))
        return model, Rules.make(mesh, model.par), unflat(case + "/p")

    def place(tree, specs):
        return jax.tree.map(lambda a, s: jax.device_put(
            a, NamedSharding(mesh, s)), tree, specs,
            is_leaf=lambda x: isinstance(x, P))

    with mesh:
        # serve layout: prefill, then greedy decode steps
        model, rules, params = setup("serve")
        specs = model.param_specs(rules)
        out["serve/dropped"] = np.array(json.dumps(rules.dropped))
        params = place(params, specs)
        shards("serve", params)
        toks = jnp.asarray(data["serve/tokens"])
        n = toks.shape[1]
        cache = jax.tree.map(lambda a: a.astype(jnp.float32),
                             model.init_cache(toks.shape[0], n + 4))
        logits, cache = jax.jit(lambda p, b, c: model.prefill_fn(
            p, b, rules, c))(params, {"tokens": toks}, cache)
        out["serve/prefill"] = np.asarray(logits)
        decode = jax.jit(lambda p, b, c: model.decode_fn(p, b, c, rules))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        steps = []
        for i in range(int(data["decode_steps"])):
            steps.append(np.asarray(tok[:, 0]))
            logits, cache = decode(params, {"tokens": tok,
                                            "pos": jnp.array(n + i)}, cache)
            out[f"serve/decode{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        out["serve/tokens"] = np.stack(steps, 1)

        # train layout: loss, gradients, one AdamW step
        model, rules, params = setup("train")
        bundle = make_train_step(model, rules, lr=float(data["lr"]),
                                 warmup=1)
        out["train/dropped"] = np.array(json.dumps(rules.dropped))
        from repro.optim import adamw_init
        state = place({"params": params,
                       "opt": adamw_init(params, "float32")},
                      bundle.state_specs)
        batch = {"tokens": jax.device_put(
            jnp.asarray(data["train/tokens"]), NamedSharding(
                mesh, bundle.batch_spec({"tokens": data["train/tokens"]})[
                    "tokens"]))}
        shards("train", state["params"])
        grads = jax.jit(jax.grad(lambda p: model.loss_fn(p, batch, rules)[0]))(
            state["params"])
        for path, g in flat(grads, ""):
            out["train/grad" + path] = np.asarray(g)
        shardings = jax.tree.map(lambda s: NamedSharding(mesh, s),
                                 bundle.state_specs,
                                 is_leaf=lambda x: isinstance(x, P))
        new, metrics = jax.jit(bundle.step_fn,
                               out_shardings=(shardings, None))(state, batch)
        out["train/loss"] = np.asarray(metrics["loss"])
        shards("train_after", new["params"])

        # the MoE's loss and aux loss (the combine across expert shards)
        model, rules, params = setup("moe")
        params = place(params, model.param_specs(rules))
        _, met = jax.jit(lambda p, b: model.loss_fn(p, b, rules))(
            params, {"tokens": jnp.asarray(data["moe/tokens"])})
        out["moe/loss"], out["moe/aux"] = (np.asarray(met["loss"]),
                                           np.asarray(met["aux"]))

        # the other families' train forward
        for case in ("rwkv", "hybrid", "encdec"):
            model, rules, params = setup(case)
            params = place(params, model.param_specs(rules))
            batch = {k[len(case) + 1:]: jnp.asarray(v) for k, v in data.items()
                     if k in (case + "/tokens", case + "/frames")}
            out[case + "/logits"] = np.asarray(jax.jit(
                lambda p, b: model.forward(p, b, rules, "train")[0])(
                    params, batch))

        # a "wtp2" leaf: tp + fsdp = ("model", "data"), model-major
        wtp2 = jax.device_put(jnp.asarray(data["wtp2"]), NamedSharding(
            mesh, rules.spec(data["wtp2"].shape, ("wtp2", None))))
        shards("wtp2", {"x": wtp2})
    np.savez(sys.argv[2], **out)
""")


def _flat(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def _qk_scaled(tree):
    return {k: _qk_scaled(v) if isinstance(v, dict)
            else v * np.float32(QK_SCALE) if k in ("wq", "wk") else v
            for k, v in tree.items()}


def _case_params(case: str):
    params = tree_map(lambda t: t.float().numpy(), torch_ranks.mesh_model(
        case).init(CASES[case][2], "cpu"))
    return _qk_scaled(params) if case in ("hybrid", "encdec") else params


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(24)
    data = {"decode_steps": np.asarray(torch_ranks.MESH_DECODE_STEPS),
            "lr": np.asarray(torch_ranks.MESH_LR),
            "wtp2": rng.standard_normal((8, 3)).astype(np.float32),
            "q/w": 0.1 * rng.standard_normal((4, 300)).astype(np.float32),
            "q/g0": rng.standard_normal((4, 300)).astype(np.float32),
            "q/g1": 2 * rng.standard_normal((4, 300)).astype(np.float32)}
    params = {}
    for case in CASES:
        params[case] = _case_params(case)
        data.update({f"{case}/p{k}": v for k, v in _flat(params[case])})
        cfg = reduced(configs.get(CASES[case][0]).model)
        B, S = torch_ranks.MESH_SHAPES.get(case, (4, 16))
        data[f"{case}/tokens"] = rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        if cfg.family == "encdec":
            data[f"{case}/frames"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
    path = tmp_path_factory.mktemp("mesh") / "inputs.npz"
    np.savez(path, **data)
    return path, data, params


@pytest.fixture(scope="module")
def runs(inputs):
    """The reference's subprocess and the port's four ranks, run at the
    same time: (the reference's arrays, each rank's arrays)."""
    path, _, _ = inputs
    ref_out = path.parent / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(path), str(ref_out),
         json.dumps(CASES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out_dir = path.parent / "ranks"
        out_dir.mkdir()
        run_ranks(torch_ranks.mesh_rank, 4,
                  args=(str(path), str(out_dir)), timeout=240)
        _, err = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(4)]
    return dict(np.load(ref_out)), ranks


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=what)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _one_device_serve_case(params_np, tokens):
    """The port's one-device prefill and greedy decode of the serve case:
    (prefill logits, decode logits, tokens)."""
    arch, cell, _ = CASES["serve"]
    bundle = configs.get(arch)
    model = build(reduced(bundle.model), bundle.parallel_for(cell, False))
    return torch_ranks.serve_case(
        model, Rules.make({"data": 1, "model": 1}, model.par),
        params_from_numpy(params_np, "cpu"), torch.from_numpy(tokens),
        torch_ranks.MESH_DECODE_STEPS)


# ------------------------------------------------------------ serve ---

def test_serve_layout_prefill_and_decode_match_the_reference(runs):
    ref, ranks = runs
    got = ranks[0]
    _close(got["serve/prefill"], ref["serve/prefill"], LOGIT_ATOL,
           LOGIT_RTOL, "prefill logits")
    for i in range(torch_ranks.MESH_DECODE_STEPS):
        _close(got[f"serve/decode{i}"], ref[f"serve/decode{i}"], LOGIT_ATOL,
               LOGIT_RTOL, f"decode step {i}")
    np.testing.assert_array_equal(got["serve/tokens"], ref["serve/tokens"])


def test_serve_layout_matches_the_one_device_port(inputs, runs):
    _, data, params = inputs
    _, ranks = runs
    pre, steps, toks = _one_device_serve_case(params["serve"],
                                              data["serve/tokens"])
    got = ranks[0]
    _close(got["serve/prefill"], pre, LOGIT_ATOL, LOGIT_RTOL)
    for i, lg in enumerate(steps):
        _close(got[f"serve/decode{i}"], lg, LOGIT_ATOL, LOGIT_RTOL)
    np.testing.assert_array_equal(got["serve/tokens"], toks)


def test_serve_launcher_on_the_mesh_gives_the_one_device_tokens(inputs,
                                                                 runs):
    _, _, params = inputs
    _, ranks = runs
    arch, cell, _ = CASES["serve"]
    bundle = configs.get(arch)
    model = build(reduced(bundle.model), bundle.parallel_for(cell, False))
    done, _ = serve(model, params_from_numpy(params["serve"], "cpu"),
                    draw_requests(*torch_ranks.MESH_SERVE_REQUESTS),
                    *torch_ranks.MESH_SERVE_SLOTS, device="cpu")
    want = torch_ranks.served_tokens(done)
    for r, rank in enumerate(ranks):
        np.testing.assert_array_equal(rank["serve_run/tokens"], want,
                                      err_msg=f"rank {r}")


# ------------------------------------------------------------ train ---

def test_train_layout_loss_grads_and_step_match_the_reference(runs):
    ref, ranks = runs
    got = ranks[0]
    assert _rel(got["train/loss"], ref["train/loss"]) <= REL
    grads = [k for k in ref if k.startswith("train/grad")]
    assert grads
    for k in grads:
        assert _rel(got[k], ref[k]) <= GRAD_REL, k


def test_int8_moments_on_a_split_last_dimension_equal_the_plain_ones(runs):
    """Two AdamW steps with int8 moments of a (4, 300) parameter laid out
    (data, model): the model axis splits its last dimension into 150s, so
    no shard holds whole blocks of 256; the gathered dimension gives the
    one-device codes exactly."""
    _, ranks = runs
    for rank in ranks:
        assert bool(rank["int8/codes_equal"])
        assert float(rank["int8/max_err"]) == 0.0


def test_moe_combine_across_expert_shards_matches_the_reference(runs):
    ref, ranks = runs
    for k in ("moe/loss", "moe/aux"):
        assert _rel(ranks[0][k], ref[k]) <= REL, k


@pytest.mark.parametrize("case", ["rwkv", "hybrid", "encdec"])
def test_family_forward_on_the_mesh_matches_the_reference(case, runs):
    ref, ranks = runs
    assert _rel(ranks[0][case + "/logits"], ref[case + "/logits"]) <= REL


# ---------------------------------------------------- per coordinate ---

@pytest.mark.parametrize("name,atol", [("serve", 0.0), ("train", 0.0),
                                       ("train_after", PARAM_ATOL),
                                       ("wtp2", 0.0)])
def test_local_blocks_equal_the_reference_shards(name, atol, runs):
    ref, ranks = runs
    keys = [k for k in ref if k.startswith(name + "/shard")]
    assert keys
    for k in keys:
        path, coord = k[len(name + "/shard"):].split("@")
        rank = next(r for r in ranks
                    if "".join(map(str, r["coord"])) == coord)
        got = rank[f"{name}/local{path}"]
        assert got.shape == ref[k].shape, (k, got.shape)
        if name != "train_after":
            _close(got, ref[k], atol, what=k)
            continue
        # the first AdamW step's conditioning (see the module docstring)
        g = np.abs(rank["train_grad/local" + path])
        clear = g > GRAD_CLEAR * np.abs(ref["train/grad" + path]).max()
        _close(got[clear], ref[k][clear], atol, what=k)
        _close(got, ref[k], 2 * torch_ranks.MESH_LR + atol, what=k)


@pytest.mark.parametrize("case", ["serve", "train"])
def test_fallbacks_equal_the_reference(case, runs):
    ref, ranks = runs
    want = [tuple(d) for d in json.loads(str(ref[case + "/dropped"]))]
    for rank in ranks:
        got = [tuple(d) for d in json.loads(str(rank[case + "/dropped"]))]
        assert got == want


# ------------------------------------------------------- checkpoints ---

def test_checkpoint_restores_on_other_meshes(runs):
    _, ranks = runs
    for r, rank in enumerate(ranks):
        assert rank["ckpt/restored_1x4"] == 0.0, f"rank {r}"
        assert rank["ckpt/restored_one"] == 0.0, f"rank {r}"


def test_resumed_and_replayed_runs_keep_the_losses(runs):
    _, ranks = runs
    got = ranks[0]
    assert np.all(np.isfinite(got["ckpt/losses"]))
    np.testing.assert_array_equal(got["ckpt/resumed"], got["ckpt/losses"])
    np.testing.assert_array_equal(got["ckpt/replayed"], got["ckpt/losses"])


# ------------------------------------------------------------ refusals ---

def test_constrain_refuses_a_plain_tensor_on_the_mesh(runs):
    _, ranks = runs
    for rank in ranks:
        assert "plain tensor" in str(rank["neg/constrain"])


def test_distributed_launcher_refuses_a_world_that_is_not_the_mesh(runs):
    _, ranks = runs
    for rank in ranks:
        msg = str(rank["neg/launch"])
        assert "world of 4 ranks" in msg and "256" in msg, msg


def test_constrain_on_a_mapping_of_more_than_one_device_refuses():
    par = configs.get("qwen2-7b").parallel_for("", False)
    with pytest.raises(ValueError, match="lays no tensor out"):
        Rules.make({"data": 2, "model": 2}, par).constrain(
            torch.zeros(4, 4), "batch", None)
    x = torch.zeros(4, 4)
    assert Rules.make({"data": 1, "model": 1}, par).constrain(
        x, "batch", None) is x


# ------------------------------------------------------- a 1 x 1 mesh ---

@pytest.fixture
def one_rank():
    """A world of one gloo rank and its 1 x 1 DeviceMesh (the layout of
    `chip_smoke.py`'s phase 18 on one card)."""
    import torch.distributed as dist
    from repro_torch.comm.group import _free_port
    from repro_torch.launch.mesh import device_mesh
    dist.init_process_group("gloo", init_method="tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        yield device_mesh({"data": 1, "model": 1}, "cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-moe-30b-a3b"])
def test_one_device_mesh_serves_and_trains_as_the_one_device_path(arch,
                                                                  one_rank):
    """On a 1 x 1 mesh the DTensor path runs the one-device path's local
    operations: the same tokens served, the same loss and gradient norm
    from a train step (equal, not close)."""
    from repro_torch.train.step import init_train_state, make_train_step
    bundle = configs.get(arch)
    cfg = reduced(bundle.model)
    model = build(cfg, bundle.parallel_for("decode_32k", False))
    params = model.init(0, "cpu")
    served = [{r.rid: r.generated for r in serve(
        model, params, draw_requests(4, cfg.vocab_size, 6, 0), 4, 64, "cpu",
        mesh)[0]} for mesh in (None, one_rank)]
    assert served[0] == served[1]
    par = bundle.parallel_for("train_4k", False)
    model = build(cfg, par)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))
    got = []
    for mesh in ({"data": 1, "model": 1}, one_rank):
        rules = Rules.make(mesh, par)
        state = init_train_state(model, 0, "cpu", rules)
        _, met = make_train_step(model, rules).step_fn(
            state, {"tokens": rules.distribute(toks, ("batch", "seq"))})
        got.append([float(torch_ranks._whole(met[k]))
                    for k in ("loss", "grad_norm")])
    assert got[0] == got[1]
