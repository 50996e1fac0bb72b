"""The port's pipeline-parallel ring (`repro_torch.comm`) against the JAX
package's, on the same numpy inputs.

One subprocess runs the reference on 4 emulated host devices
(``--xla_force_host_platform_device_count=4``) once for the module: the
pipeline's loss and ``jax.grad`` for ``plans=``, ``"reorder-buffer"`` and
``"pallas:ppermute"``, and the sequential composition's loss and grad.  The
port must give the same loss and gradients within 1e-6 on a
``LocalGroup(4, "cpu")`` and on a 4-rank gloo `DistGroup` (spawned once for
the module, `tests/torch_ranks.py`), for ``plans=``, ``"reorder-buffer"``
and ``"cuda:ppermute"``.  Also ported: `tests/test_runtime.py`'s
ring-lowering case, with negatives (a backend without a step hook, shifts
without wrap, the all-reduce-backward pitfall).  `chip_smoke.py`'s
`DistGroup` hand-off, which phase 13 runs under NCCL where a machine has
several cards, runs here under gloo.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks  # noqa: E402
from repro_torch.comm import (LocalGroup, PipelineSpec,  # noqa: E402
                              analyze_pipeline, fifo_shift,
                              pipeline_train_step, reorder_buffer_read,
                              ring_lowering, run_ranks, stage_params)
from repro_torch.comm.channels import ring_gather, ring_hop  # noqa: E402
from repro_torch.comm.pipeline import _resolve_lowering  # noqa: E402
from repro_torch.runtime import (BROADCAST_REGISTER,  # noqa: E402
                                 CHUNK_SPLIT, DEPTH_SPLIT, FIFO_STREAM,
                                 REORDER_BUFFER, backend)

ROOT = Path(__file__).resolve().parent.parent
S, D, M, MB = 4, 16, 8, 4
TOL = 1e-6
#: the reference's counterpart of each of the port's selections
REFERENCE_SELECTION = {"plans": "plans", "reorder-buffer": "reorder-buffer",
                       "cuda:ppermute": "pallas:ppermute"}

JAX_SIDE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.comm import PipelineSpec, analyze_pipeline
from repro.comm.pipeline import pipeline_loss_fn

data = np.load(sys.argv[1])
params = {"w": jnp.asarray(data["w"]), "b": jnp.asarray(data["b"])}
xs, tg = jnp.asarray(data["xs"]), jnp.asarray(data["tg"])
S, M = params["w"].shape[0], xs.shape[0]
mesh = Mesh(np.array(jax.devices()).reshape(4), ("pipe",))

def stage_fn(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])

def loss_head(h, tgt):
    return jnp.mean((h - tgt) ** 2)

def ref_loss(params, xs, tg):
    def one(mb_x, mb_t):
        h = mb_x
        for s in range(S):
            h = stage_fn({"w": params["w"][s], "b": params["b"][s]}, h)
        return loss_head(h, mb_t)
    return jnp.mean(jax.vmap(one)(xs, tg))

out = {}
loss, g = jax.jit(jax.value_and_grad(ref_loss))(params, xs, tg)
out["sequential/loss"] = np.asarray(loss)
for k in g:
    out[f"sequential/grad_{k}"] = np.asarray(g[k])
_, plans = analyze_pipeline(PipelineSpec(stages=S, microbatches=M))
for name, kwargs in (("plans", {"plans": plans}),
                     ("reorder-buffer", {"lowering": "reorder-buffer"}),
                     ("pallas:ppermute", {"lowering": "pallas:ppermute"})):
    f = pipeline_loss_fn(stage_fn, loss_head, mesh, "pipe", **kwargs)
    loss, g = jax.jit(jax.value_and_grad(f))(params, xs, tg)
    out[f"{name}/loss"] = np.asarray(loss)
    for k in g:
        out[f"{name}/grad_{k}"] = np.asarray(g[k])
np.savez(sys.argv[2], **out)
"""


def _stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _loss_head(h, tgt):
    return torch.mean((h - tgt) ** 2)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(19)
    data = {"w": 0.5 * rng.standard_normal((S, D, D)),
            "b": 0.1 * rng.standard_normal((S, D)),
            "xs": rng.standard_normal((M, MB, D)),
            "tg": rng.standard_normal((M, MB, D))}
    data = {k: v.astype(np.float32) for k, v in data.items()}
    path = tmp_path_factory.mktemp("pipeline") / "inputs.npz"
    np.savez(path, **data)
    return path, data


@pytest.fixture(scope="module")
def reference(inputs):
    path, _ = inputs
    out = path.parent / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def gloo(inputs):
    path, _ = inputs
    out_dir = path.parent / "gloo"
    out_dir.mkdir()
    run_ranks(torch_ranks.pipeline_rank, 4, args=(str(path), str(out_dir)),
              timeout=120)
    return torch_ranks.load_ranks(out_dir, 4)


def _close(got, want, what):
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    assert err <= TOL, f"{what}: max abs error {err:.3g} > {TOL}"


@pytest.mark.parametrize("selection", torch_ranks.SELECTIONS)
def test_local_group_matches_reference(selection, inputs, reference):
    _, data = inputs
    ref = REFERENCE_SELECTION[selection]
    loss, grads = torch_ranks.pipeline_grads(
        LocalGroup(4, "cpu"), {"w": data["w"], "b": data["b"]},
        torch.from_numpy(data["xs"]), torch.from_numpy(data["tg"]),
        **torch_ranks.selection_kwargs(selection, S, M))
    _close(loss, reference[f"{ref}/loss"], f"{selection} loss")
    _close(loss, reference["sequential/loss"], f"{selection} loss")
    for k, g in grads.items():
        _close(g, reference[f"{ref}/grad_{k}"], f"{selection} grad {k}")
        _close(g, reference[f"sequential/grad_{k}"], f"{selection} grad {k}")


@pytest.mark.parametrize("selection", torch_ranks.SELECTIONS)
def test_gloo_group_matches_reference(selection, reference, gloo):
    ref = REFERENCE_SELECTION[selection]
    for r in range(S):                        # the loss, on every rank
        _close(gloo[f"{selection}/loss"][r], reference[f"{ref}/loss"],
               f"{selection} loss on rank {r}")
    for k in ("w", "b"):
        got = gloo[f"{selection}/grad_{k}"]
        _close(got, reference[f"{ref}/grad_{k}"], f"{selection} grad {k}")
        _close(got, reference[f"sequential/grad_{k}"],
               f"{selection} grad {k}")


def test_gloo_group_does_not_all_reduce_in_backward(reference, gloo):
    """Every rank seeds its own copy of the replicated loss: an all-reduce
    in backward multiplies each gradient by n, the port's group does not."""
    for k in ("w", "b"):
        want = reference[f"sequential/grad_{k}"]
        got = gloo[f"plans/grad_{k}"]
        assert not np.allclose(got, S * want, atol=TOL)
        _close(got, want, f"grad {k}")
        _close(gloo[f"all_reduce_in_backward/grad_{k}"], S * want,
               f"grad {k} with an all-reduce in backward")


def test_shifts_without_wrap_give_the_first_stages_zeros(gloo):
    want = {1: [0, 1, 2, 3], -1: [2, 3, 4, 0]}
    wrapped = {1: [4, 1, 2, 3], -1: [2, 3, 4, 1]}
    local = LocalGroup(4, "cpu")
    x = torch.arange(1.0, 5.0)[:, None].expand(4, 3)
    for k in (1, -1):
        assert gloo[f"shift_{k}"][:, 0].tolist() == want[k]
        assert gloo[f"shift_{k}_wrap"][:, 0].tolist() == wrapped[k]
        assert fifo_shift(x, local, k)[:, 0].tolist() == want[k]
        assert fifo_shift(x, local, k, wrap=True)[:, 0].tolist() == wrapped[k]
    assert fifo_shift(x, local, 4).abs().sum() == 0


def test_reorder_buffer_reads_any_producer():
    local = LocalGroup(4, "cpu")
    x = torch.arange(4.0)[:, None] * 10 + torch.arange(3.0)
    got = reorder_buffer_read(x, local, torch.tensor([3, 3, 0, 1]))
    assert torch.equal(got, x[[3, 3, 0, 1]])


def test_sgd_steps_lower_the_loss(inputs):
    _, data = inputs
    group = LocalGroup(4, "cpu")
    _, plans = analyze_pipeline(PipelineSpec(stages=S, microbatches=M))
    step = pipeline_train_step(_stage_fn, _loss_head, group, plans=plans,
                               lr=0.05)
    params = stage_params({"w": data["w"], "b": data["b"]}, group)
    xs, tg = torch.from_numpy(data["xs"]), torch.from_numpy(data["tg"])
    losses = []
    for _ in range(30):
        params, loss = step(params, xs, tg)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses
    assert all(not p.requires_grad for p in params.values())


@pytest.mark.parametrize("lowering", ["reference:ppermute",
                                      "selftimed:reorder-buffer"])
def test_backend_without_a_step_hook_raises(lowering):
    with pytest.raises(ValueError, match=lowering.split(":")[0]):
        pipeline_train_step(_stage_fn, _loss_head, LocalGroup(4, "cpu"),
                            lowering=lowering)


def test_run_ranks_kills_ranks_that_outlive_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="within 2"):
        run_ranks(torch_ranks.sleeping_rank, 2, args=(600,), timeout=2)
    assert time.monotonic() - t0 < 30


def test_example_trains_on_the_cpu(capsys):
    from repro_torch.examples.train_pipeline import main

    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "registry selects 'ppermute'" in out
    assert "loss decreased across 4 pipeline stages" in out
    assert "lowering='cuda:ppermute'" in out


def test_stage_params_refuse_a_wrong_stage_count():
    with pytest.raises(ValueError, match="4 stages"):
        stage_params({"w": np.zeros((3, 2, 2), np.float32)},
                     LocalGroup(4, "cpu"))


# ---------------------- ported from tests/test_runtime.py (comm side) -------


def test_pipeline_ring_lowering_from_plan_records():
    _, plans = analyze_pipeline(PipelineSpec(stages=4, microbatches=8))
    assert ring_lowering(plans) == FIFO_STREAM
    assert ring_lowering([p.as_dict() for p in plans]) == FIFO_STREAM
    assert plans[0].topology == "pipeline"
    forced = [dataclasses.replace(plans[0], lowering=REORDER_BUFFER)]
    assert ring_lowering(forced + list(plans[1:])) == REORDER_BUFFER
    assert ring_lowering([]) == FIFO_STREAM


def test_resolve_lowering_takes_plans_then_a_name_then_the_stream():
    _, plans = analyze_pipeline(PipelineSpec(stages=4, microbatches=8))
    assert _resolve_lowering(REORDER_BUFFER, plans) == FIFO_STREAM
    assert _resolve_lowering(REORDER_BUFFER, None) == REORDER_BUFFER
    assert _resolve_lowering("cuda:ppermute", None) == "cuda:ppermute"
    assert _resolve_lowering(None, None) == FIFO_STREAM


@pytest.mark.parametrize("bname", ["torch", "cuda"])
def test_backends_share_the_ring_steps(bname):
    """Both backends' lowerings step the ring through `comm.channels`'
    two steps: the ppermute family hops, the reorder buffer gathers."""
    b = backend(bname)
    for lname in (FIFO_STREAM, DEPTH_SPLIT, CHUNK_SPLIT, BROADCAST_REGISTER):
        assert b.implementation(lname).step is ring_hop, lname
    assert b.implementation(REORDER_BUFFER).step is ring_gather


def test_chip_smoke_dist_group_hand_off_under_gloo(tmp_path, monkeypatch):
    """`chip_smoke.dist_pipeline_errors`, phase 13's NCCL hand-off (inputs
    written, ranks spawned, stages stacked in rank order, each selection
    against a CPU `LocalGroup`), run over 4 gloo ranks."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    errs = chip_smoke.dist_pipeline_errors(4, "gloo", 19, tmp_path / "dist")
    assert sorted(errs) == sorted(torch_ranks.SELECTIONS)
    for name, err in errs.items():
        assert sorted(err) == ["b", "loss", "w"], err
        assert max(err.values()) <= chip_smoke.PIPE_TOL, (name, err)
