"""The port's optimizers (`repro_torch.optim`) against the JAX package's, on
the same numpy inputs.

One subprocess runs the reference once for the module, on 4 emulated host
devices (``--xla_force_host_platform_device_count=4``):
`compressed_psum_mean` on a (4, 64) input and 120 error-feedback steps of
`tests/test_compression.py`'s distributed quadratic over a ``dp`` axis;
`quantize_array` / `dequantize_array` at last dimensions 1, 255, 256, 257
and 0-d; three `adamw_update` steps in float32 and with int8 state, with
and without ``chunk_threshold``; `cosine_warmup` at a few steps.  The port
runs the compression on a ``LocalGroup(4, "cpu")`` and on a 4-rank gloo
`DistGroup` (spawned once for the module, `tests/torch_ranks.py`).  int8
codes must be equal element for element, everything else within 1e-6.

The error-feedback run is compared step by step: each of the port's steps
starts from the reference's state after the step before.  Whole runs are
not compared element for element, because XLA fuses ``val − q·scale`` and
``w − 0.3·mean`` into fused multiply-adds, so one step's results differ
from the port's in the last bit (1e-7 here), and over 120 steps such a bit
can carry a value across a rounding boundary of the int8 codes, which then
differ by one.  Each whole run must converge as the reference's does.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks  # noqa: E402
from repro_torch.comm import LocalGroup, run_ranks  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               cosine_warmup, dequantize_state,
                               quantize_state)
from repro_torch.optim.compression import (  # noqa: E402
    compressed_grad_sync, compressed_psum_mean, init_error_feedback)
from repro_torch.optim.quantized import (  # noqa: E402
    BLOCK, dequantize_array, quantize_array, scale_shape)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6
EF_STEPS = 120
#: quantized shapes: last dimensions 1, 255, 256 (one block), 257 and 0-d
Q_SHAPES = {"last1": (3, 1), "last255": (2, 255), "last256": (256,),
            "last257": (3, 257), "scalar": ()}
#: adamw variants: state dtype and chunk threshold (the default, or one the
#: stacked parameter passes, so it is updated slice by slice)
ADAMW = {"f32": ("float32", 1 << 60), "f32-chunked": ("float32", 1000),
         "int8": ("int8", 1 << 60), "int8-chunked": ("int8", 1000)}
ADAMW_STEPS = 3
LR_STEPS = (0, 3, 9, 10, 11, 55, 99, 100, 150)

JAX_SIDE = r"""
import contextlib, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.comm.pipeline import _shard_map
from repro.optim import adamw_init, adamw_update, cosine_warmup
from repro.optim.compression import compressed_psum_mean
from repro.optim.quantized import dequantize_array, quantize_array

data = dict(np.load(sys.argv[1]))
out = {}
if hasattr(jax.sharding, "AxisType"):
    mesh = jax.make_mesh((4,), ("dp",),
                         axis_types=(jax.sharding.AxisType.Auto,))
else:
    mesh = jax.make_mesh((4,), ("dp",))
use_mesh = getattr(jax, "set_mesh", None) or contextlib.nullcontext

f = _shard_map(lambda g, e: compressed_psum_mean(g, e, "dp"), mesh,
               in_specs=(P("dp"), P("dp")), out_specs=(P("dp"), P("dp")))

def ef_step(w, t, e):
    mean_g, e = compressed_psum_mean(w - t, e, "dp")
    return w - 0.3 * mean_g, e

fstep = _shard_map(ef_step, mesh, in_specs=(P("dp"), P("dp"), P("dp")),
                   out_specs=(P("dp"), P("dp")))
with use_mesh(mesh):
    g = jnp.asarray(data["g"])
    out["mean"], out["err"] = map(np.asarray, jax.jit(f)(g, jnp.zeros_like(g)))
    w, t = jnp.asarray(data["w0"]), jnp.asarray(data["targets"])
    e = jnp.zeros_like(w)
    jstep = jax.jit(fstep)
    traj = [(w, e)]
    for _ in range(int(data["ef_steps"])):
        w, e = jstep(w, t, e)
        traj.append((w, e))
    out["traj_w"] = np.stack([np.asarray(a) for a, _ in traj])
    out["traj_e"] = np.stack([np.asarray(b) for _, b in traj])

for k in [k for k in data if k.startswith("q/")]:
    x = jnp.asarray(data[k])
    s = quantize_array(x)
    out[k + "/q"], out[k + "/scale"] = np.asarray(s["q"]), np.asarray(s["scale"])
    out[k + "/x"] = np.asarray(dequantize_array(s, x.shape))

for name, (state_dtype, chunk) in eval(sys.argv[3]).items():
    params = {k: jnp.asarray(data["p/" + k]) for k in ("w", "b", "s")}
    opt = adamw_init(params, state_dtype)
    for i in range(int(data["adamw_steps"])):
        grads = {k: jnp.asarray(data[f"g{i}/" + k]) for k in params}
        params, opt, gnorm = adamw_update(params, grads, opt, 1e-2,
                                          state_dtype=state_dtype,
                                          chunk_threshold=chunk)
        out[f"{name}/gnorm{i}"] = np.asarray(gnorm)
    for k in params:
        out[f"{name}/p/{k}"] = np.asarray(params[k])
        for m in ("m", "v"):
            st = opt[m][k]
            if state_dtype == "int8":
                out[f"{name}/{m}/{k}/q"] = np.asarray(st["q"])
                out[f"{name}/{m}/{k}/scale"] = np.asarray(st["scale"])
            else:
                out[f"{name}/{m}/{k}"] = np.asarray(st)
    out[f"{name}/step"] = np.asarray(opt["step"])

lr = cosine_warmup(1e-3, 10, 100)
out["lr"] = np.asarray([lr(jnp.int32(s)) for s in data["lr_steps"]])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(19)
    data = {"g": rng.standard_normal((4, 64)),
            "w0": np.full((4, 8), 3.0),
            "targets": rng.standard_normal((4, 8)),
            "p/w": 0.1 * rng.standard_normal((4, 8, 300)),
            "p/b": 0.1 * rng.standard_normal((4, 8)),
            "p/s": np.asarray(0.5)}
    for i in range(ADAMW_STEPS):
        for k in ("w", "b", "s"):
            data[f"g{i}/{k}"] = (i + 1) * rng.standard_normal(
                data["p/" + k].shape)
    for k, shape in Q_SHAPES.items():
        data["q/" + k] = rng.standard_normal(shape)
    data = {k: np.asarray(v, np.float32) for k, v in data.items()}
    data.update(ef_steps=np.asarray(EF_STEPS),
                adamw_steps=np.asarray(ADAMW_STEPS),
                lr_steps=np.asarray(LR_STEPS))
    path = tmp_path_factory.mktemp("optim") / "inputs.npz"
    np.savez(path, **data)
    return path, data


@pytest.fixture(scope="module")
def reference(inputs):
    path, _ = inputs
    out = path.parent / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path),
                           str(out), repr(ADAMW)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def gloo(inputs, reference):
    path, _ = inputs
    out_dir = path.parent / "gloo"
    out_dir.mkdir()
    run_ranks(torch_ranks.compression_rank, 4,
              args=(str(path), str(path.parent / "reference.npz"),
                    str(out_dir)), timeout=120)
    return torch_ranks.load_ranks(out_dir, 4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, what):
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want),
                       initial=0.0))
    assert err <= TOL, f"{what}: max abs error {err:.3g} > {TOL}"




def test_compressed_mean_on_local_group(inputs, reference):
    _, data = inputs
    g = _t(data["g"])
    mean, err = compressed_psum_mean(g, torch.zeros_like(g),
                                     LocalGroup(4, "cpu"))
    _close(mean, reference["mean"], "mean")
    _close(err, reference["err"], "error feedback")
    # the reference test's bounds
    bound = float(g.abs().max()) / 127.0 + 1e-6
    exact = g.mean(0, keepdim=True).expand_as(g)
    assert float((mean - exact).abs().max()) <= bound
    assert float(err.abs().max()) <= bound


def test_error_feedback_steps_on_local_group(inputs, reference):
    _, data = inputs
    group, t = LocalGroup(4, "cpu"), _t(data["targets"])
    traj_w, traj_e = reference["traj_w"], reference["traj_e"]
    for i in range(EF_STEPS):
        w, e = torch_ranks.ef_step(_t(traj_w[i]), t, _t(traj_e[i]), group)
        _close(w, traj_w[i + 1], f"w after EF step {i + 1}")
        _close(e, traj_e[i + 1], f"error after EF step {i + 1}")
    w, _ = torch_ranks.ef_run(_t(data["w0"]), t, EF_STEPS, group)
    opt = t.mean(0, keepdim=True)
    assert float((w - opt).abs().max()) < 0.05
    assert float(np.abs(traj_w[-1] - opt.numpy()).max()) < 0.05


def test_compression_on_gloo_group(inputs, reference, gloo):
    _, data = inputs
    for k in ("mean", "err"):
        _close(gloo[k], reference[k], f"{k} on 4 gloo ranks")
    for k in ("w", "e"):
        # (rank, step, …) against the reference's (step, rank, …)
        _close(gloo["steps_" + k], reference["traj_" + k][1:].swapaxes(0, 1),
               f"{k} after each EF step on 4 gloo ranks")
    opt = data["targets"].mean(0, keepdims=True)
    assert float(np.abs(gloo["w"] - opt).max()) < 0.05


def test_compressed_grad_sync_is_per_leaf(inputs, reference):
    _, data = inputs
    group = LocalGroup(4, "cpu")
    grads = {"a": _t(data["g"]), "b": _t(data["targets"])}
    errors = init_error_feedback(grads)
    assert all(float(e.abs().sum()) == 0.0 for e in errors.values())
    means, new_err = compressed_grad_sync(grads, errors, group)
    _close(means["a"], reference["mean"], "mean of leaf a")
    want, _ = compressed_psum_mean(grads["b"], errors["b"], group)
    assert torch.equal(means["b"], want)
    _close(new_err["a"], reference["err"], "error of leaf a")


@pytest.mark.parametrize("name", sorted(Q_SHAPES))
def test_quantize_array_matches_reference(name, inputs, reference):
    _, data = inputs
    key = "q/" + name
    s = quantize_array(_t(data[key]))
    assert s["q"].dtype == torch.int8
    assert np.array_equal(s["q"].numpy(), reference[key + "/q"])
    assert tuple(s["scale"].shape) == scale_shape(Q_SHAPES[name])
    _close(s["scale"], reference[key + "/scale"], f"{name} scale")
    back = dequantize_array(s, Q_SHAPES[name])
    assert tuple(back.shape) == Q_SHAPES[name]
    _close(back, reference[key + "/x"], f"{name} dequantized")


def test_quantize_state_round_trips_within_a_code():
    rng = np.random.default_rng(3)
    tree = {"a": _t(rng.standard_normal((2, BLOCK + 3)).astype(np.float32)),
            "b": _t(np.float32(rng.standard_normal()))}
    back = dequantize_state(quantize_state(tree), tree)
    for k, x in tree.items():
        assert back[k].shape == x.shape
        assert float((back[k] - x).abs().max()) <= float(x.abs().max()) / 254


@pytest.mark.parametrize("name", sorted(ADAMW))
def test_adamw_update_matches_reference(name, inputs, reference):
    _, data = inputs
    state_dtype, chunk = ADAMW[name]
    params = {k: _t(data["p/" + k]) for k in ("w", "b", "s")}
    opt = adamw_init(params, state_dtype)
    for i in range(ADAMW_STEPS):
        grads = {k: _t(data[f"g{i}/{k}"]) for k in params}
        params, opt, gnorm = adamw_update(params, grads, opt, 1e-2,
                                          state_dtype=state_dtype,
                                          chunk_threshold=chunk)
        _close(float(gnorm) / float(reference[f"{name}/gnorm{i}"]), 1.0,
               f"gnorm {i}")
    assert int(opt["step"]) == int(reference[f"{name}/step"]) == ADAMW_STEPS
    for k, p in params.items():
        _close(p, reference[f"{name}/p/{k}"], f"{name} param {k}")
        for m in ("m", "v"):
            st = opt[m][k]
            if state_dtype == "int8":
                assert np.array_equal(st["q"].numpy(),
                                      reference[f"{name}/{m}/{k}/q"]), (m, k)
                _close(st["scale"], reference[f"{name}/{m}/{k}/scale"],
                       f"{name} {m} {k} scale")
            else:
                _close(st, reference[f"{name}/{m}/{k}"], f"{name} {m} {k}")


def test_cosine_warmup_matches_reference(reference):
    lr = cosine_warmup(1e-3, 10, 100)
    got = [float(lr(s)) for s in LR_STEPS]
    _close(got, reference["lr"], "learning rate")
    assert float(lr(torch.tensor(150))) == pytest.approx(1e-4)
