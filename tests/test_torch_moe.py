"""The port's MoE layer (`repro_torch.models.moe`) against the JAX package's
(`repro.models.moe`), on the CPU, in float32.

Reduced qwen3-moe-30b-a3b (E = 8, K = 2, d_model 64), B = 2 x S = 16 tokens,
one group: capacity 12 slots an expert.  Parameters are drawn by the JAX
package and carried over with `params_from_numpy`; the JAX side is jitted
once per case in a module-scoped fixture.

1. ``y`` and ``aux`` equal the reference's within 1e-5 of the largest
   output, with no expert overflowing (capacity factor 8) and with every
   token routed to experts 0 and 1 by a router whose winners are clear (no
   ties at the top-k boundary), so both overflow.
2. On the overflow, the tokens that get expert 0's output (every other
   expert's ``wo`` zeroed) number cap − 1 = 11 on both sides: the
   reference's scatters leave slot cap − 1 empty, and the port keeps that
   as a rule.
3. No scatter in the forward meets a repeated index (a `TorchFunctionMode`
   sees every scatter, index_put and index_add call, and there must be at
   least one).
4. Gradients of a random projection of ``y`` plus ``aux`` with respect to
   every parameter and to x equal ``jax.grad``'s within 1e-5 of each
   leaf's largest entry.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models.moe import apply_moe as japply_moe  # noqa: E402
from repro.models.moe import moe_plan as jmoe_plan  # noqa: E402
from repro.models.common import init_params as jinit_params  # noqa: E402
from repro.models.sharding import Rules as JRules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.models import Rules  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.models.moe import apply_moe, capacity  # noqa: E402

MESH = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
ARCH = "qwen3-moe-30b-a3b"
B, S = 2, 16
REL = 1e-5
CASES = ("balanced", "overflow")


def _cfg(case: str):
    cf = 8.0 if case == "balanced" else 1.25
    return (dataclasses.replace(jreduced(jconfigs.get(ARCH).model),
                                capacity_factor=cf),
            dataclasses.replace(reduced(configs.get(ARCH).model),
                                capacity_factor=cf))


def _inputs(case: str, cfg):
    """float32 parameters and x.  For the overflow, x's first channel is
    1–2 and the router's first row 4, 3, then −1, −1.1, …: every token's
    two largest logits are experts 0 and 1, each at least ~1 above the
    rest, and no two experts tie."""
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jinit_params(jax.random.PRNGKey(7),
                                       jmoe_plan(cfg)))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if case == "overflow":
        x[..., 0] = 1.0 + rng.random((B, S))
        router = 0.01 * rng.standard_normal(params["router"].shape)
        router[0] = [4.0, 3.0] + [-1.0 - 0.1 * e
                                  for e in range(cfg.num_experts - 2)]
        params["router"] = router.astype(np.float32)
    return params, x


def _jax_loss(p, x, r, cfg, rules):
    y, aux = japply_moe(p, x, cfg, rules)
    return jnp.sum(y * r) + aux


@pytest.fixture(scope="module", params=CASES)
def ref(request):
    case = request.param
    jcfg, cfg = _cfg(case)
    par = jconfigs.get(ARCH).parallel_for("decode_32k", multi_pod=False)
    jrules = JRules.make(MESH, par)
    params, x = _inputs(case, jcfg)
    r = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)
    served = dict(params, wo=params["wo"] * (np.arange(
        jcfg.num_experts) == 0)[:, None, None].astype(np.float32))
    with MESH:
        fwd = jax.jit(lambda p, x: japply_moe(p, x, jcfg, jrules))
        y, aux = fwd(params, x)
        y0, _ = fwd(served, x)
        gp, gx = jax.jit(jax.grad(
            lambda p, x: _jax_loss(p, x, r, jcfg, jrules),
            argnums=(0, 1)))(params, x)
    return {"case": case, "cfg": cfg, "rules": Rules.make(
        {"data": 1, "model": 1}, par), "params": params, "x": x, "r": r,
        "served": served, "y": np.asarray(y), "aux": float(aux),
        "y0": np.asarray(y0), "gp": jax.tree.map(np.asarray, gp),
        "gx": np.asarray(gx)}


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert want.shape == got.shape
    return float(np.abs(want - got).max()
                 / max(float(np.abs(want).max()), 1e-30))


@torch.no_grad()
def test_apply_moe_matches_jax(ref):
    cfg = ref["cfg"]
    y, aux = apply_moe(params_from_numpy(ref["params"], "cpu"),
                       torch.from_numpy(ref["x"]), cfg, ref["rules"])
    assert _rel(ref["y"], y) <= REL
    assert abs(aux.item() - ref["aux"]) <= REL * abs(ref["aux"])
    assert aux.dtype == torch.float32 and y.dtype == torch.float32


@torch.no_grad()
def test_overflowing_expert_serves_cap_minus_one_tokens(ref):
    """Only expert 0 writes an output: its served tokens are the rows of y
    that are not zero."""
    cfg = ref["cfg"]
    y0, _ = apply_moe(params_from_numpy(ref["served"], "cpu"),
                      torch.from_numpy(ref["x"]), cfg, ref["rules"])
    assert _rel(ref["y0"], y0) <= REL
    got = int((y0.reshape(B * S, -1).abs().amax(-1) > 0).sum())
    want = int((np.abs(ref["y0"]).reshape(B * S, -1).max(-1) > 0).sum())
    cap = capacity(B * S, cfg)
    if ref["case"] == "overflow":
        assert cap == 12 and got == want == cap - 1
    else:
        assert cap >= B * S and got == want < cap


class _Scatters(TorchFunctionMode):
    """Records the index of every scatter-like call and whether it repeats
    an index along the scattered dimension."""
    NAMES = ("scatter", "scatter_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_", "index_put",
             "index_put_", "index_add", "index_add_", "index_copy",
             "index_copy_", "put_", "index_fill_", "__setitem__")

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in self.NAMES:
            self.calls.append((name, self._repeats(name, args, kwargs)))
        return func(*args, **kwargs)

    @staticmethod
    def _repeats(name, args, kwargs) -> bool:
        if name.startswith("scatter"):
            dim, index = args[1], args[2] if len(args) > 2 else kwargs["index"]
            idx = torch.movedim(index, dim, -1).reshape(-1, index.shape[dim])
            return any(len(set(row.tolist())) < len(row) for row in idx)
        if name == "__setitem__":
            key = args[1]
            keys = key if isinstance(key, tuple) else (key,)
            tensors = [k for k in keys if isinstance(k, torch.Tensor)
                       and k.dtype != torch.bool]
            return any(len(set(t.reshape(-1).tolist())) < t.numel()
                       for t in tensors)
        return True                   # any other form counts as a repeat


@torch.no_grad()
def test_no_dispatch_scatter_receives_a_repeated_index(ref):
    cfg = ref["cfg"]
    params = params_from_numpy(ref["params"], "cpu")
    x = torch.from_numpy(ref["x"])
    with _Scatters() as seen:
        apply_moe(params, x, cfg, ref["rules"])
    assert seen.calls, "the mode saw no scatter"
    assert not any(rep for _, rep in seen.calls), seen.calls


def test_gradients_match_jax_grad(ref):
    cfg = ref["cfg"]
    params = {k: v.clone().requires_grad_(True)
              for k, v in params_from_numpy(ref["params"], "cpu").items()}
    x = torch.from_numpy(ref["x"]).requires_grad_(True)
    y, aux = apply_moe(params, x, cfg, ref["rules"])
    ((y * torch.from_numpy(ref["r"])).sum() + aux).backward()
    errs = {k: _rel(ref["gp"][k], p.grad) for k, p in params.items()}
    errs["x"] = _rel(ref["gx"], x.grad)
    assert max(errs.values()) <= REL, errs
