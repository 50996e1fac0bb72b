"""The port's Mamba block (`repro_torch.models.ssm`) against the JAX package's
(`repro.models.ssm`), on the CPU, in float32.

Reduced jamba-1.5-large-398b (d_model 64, d_inner 128, d_state 16, conv
width 4), parameters drawn by the JAX package with ``A_log`` drawn too (the
init sets it to 0, a decay of exp(−dt) in every channel), carried over with
`params_from_numpy`.  Each JAX function is jitted once per shape.

1. `_ssm_block_scan` (the port's log-step scan against the reference's
   ``associative_scan``) at one step, 7 and 512 steps, the 512 with decays
   whose running product underflows float32.
2. `apply_mamba` in train mode, and in prefill from a random carried cache,
   at S = 16 (one block), S = 1100 (ceil(1100/512) = 3 does not divide it:
   four blocks of 275) and, with ``block=8``, S = 20 (four of 5) and S = 24
   (three of 8): the output and the returned cache.
3. Decode, one token from a random cache: the output and the cache.

Every comparison holds the port within 1e-5 of the reference's largest
entry.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import Mesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import init_params as jinit_params  # noqa: E402
from repro.models.sharding import Rules as JRules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.models import Rules, ssm  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402

MESH = Mesh(np.array(jax.devices()).reshape(1, 1), ("data", "model"))
ARCH = "jamba-1.5-large-398b"
B = 2
REL = 1e-5
#: (S, block): one block, the default split where ceil(S/512) does not
#: divide S, and two small blocks where it does not and where it does
SHAPES = ((16, 512), (1100, 512), (20, 8), (24, 8))


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(jconfigs.get(ARCH).model)
    cfg = reduced(configs.get(ARCH).model)
    par = jconfigs.get(ARCH).parallel_for("decode_32k", multi_pod=False)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jinit_params(jax.random.PRNGKey(3),
                                       jssm.mamba_plan(jcfg)))
    rng = np.random.default_rng(21)
    params["A_log"] = np.log(rng.uniform(1.0, 16.0, params["A_log"].shape)
                             ).astype(np.float32)
    params["dt_bias"] = (0.5 * rng.standard_normal(params["dt_bias"].shape)
                         ).astype(np.float32)
    return {"jcfg": jcfg, "cfg": cfg, "jrules": JRules.make(MESH, par),
            "rules": Rules.make({"data": 1, "model": 1}, par),
            "params": params, "tparams": params_from_numpy(params, "cpu")}


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert want.shape == got.shape, (want.shape, got.shape)
    return float(np.abs(want - got).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _cache(setup, seed: int) -> dict:
    cfg = setup["cfg"]
    di = cfg.ssm_expand * cfg.d_model
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal(
                (B, cfg.ssm_conv_width - 1, di)).astype(np.float32),
            "ssm": rng.standard_normal(
                (B, di, cfg.ssm_state_dim)).astype(np.float32)}


@pytest.mark.parametrize("L", [1, 7, 512])
def test_block_scan_matches_the_associative_scan(L):
    rng = np.random.default_rng(L)
    decay = rng.uniform(0.05 if L == 512 else 0.5, 1.0,
                        (B, L, 8, 4)).astype(np.float32)
    drive = rng.standard_normal((B, L, 8, 4)).astype(np.float32)
    h0 = rng.standard_normal((B, 8, 4)).astype(np.float32)
    if L == 512:                       # the running product underflows
        assert np.prod(decay[0, :, 0, 0].astype(np.float64)) < 1e-38
    want_all, want_last = jax.jit(jssm._ssm_block_scan)(decay, drive, h0)
    got_all, got_last = ssm._ssm_block_scan(
        *(torch.from_numpy(a) for a in (decay, drive, h0)))
    assert _rel(want_all, got_all) <= REL
    assert _rel(want_last, got_last) <= REL


@pytest.mark.parametrize("S,block", SHAPES)
def test_num_blocks_is_the_references_split(S, block):
    nb = ssm.num_blocks(S, block)
    assert S % nb == 0 and nb >= -(-S // block)
    assert all(S % k for k in range(-(-S // block), nb))
    assert (nb == -(-S // block)) == (S in (16, 24))


@torch.no_grad()
@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("S,block", SHAPES)
def test_apply_mamba_matches_jax(setup, mode, S, block):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    x = np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    cache = _cache(setup, S + 1) if mode == "prefill" else None
    want, want_cache = jax.jit(
        lambda p, x, c: jssm.apply_mamba(p, x, jcfg, setup["jrules"], mode,
                                         c, block=block))(
        setup["params"], x, cache)
    got, got_cache = ssm.apply_mamba(
        setup["tparams"], torch.from_numpy(x), cfg, setup["rules"], mode,
        None if cache is None else params_from_numpy(cache, "cpu"),
        block=block)
    assert _rel(want, got) <= REL
    if mode == "train":
        assert got_cache is None and want_cache is None
    else:
        assert set(got_cache) == {"conv", "ssm"}
        for k in got_cache:
            assert _rel(want_cache[k], got_cache[k]) <= REL, k


@torch.no_grad()
def test_decode_matches_jax(setup):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    x = np.random.default_rng(5).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    cache = _cache(setup, 6)
    want, want_cache = jax.jit(
        lambda p, x, c: jssm.apply_mamba(p, x, jcfg, setup["jrules"],
                                         "decode", c))(
        setup["params"], x, cache)
    got, got_cache = ssm.apply_mamba(
        setup["tparams"], torch.from_numpy(x), cfg, setup["rules"], "decode",
        params_from_numpy(cache, "cpu"))
    assert _rel(want, got) <= REL
    for k in ("conv", "ssm"):
        assert _rel(want_cache[k], got_cache[k]) <= REL, k


def test_cache_shapes_are_the_references():
    jcfg, cfg = jreduced(jconfigs.get(ARCH).model), \
        reduced(configs.get(ARCH).model)
    assert ssm.mamba_cache_shapes(cfg, 3) == jssm.mamba_cache_shapes(jcfg, 3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
