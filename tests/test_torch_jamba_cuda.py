"""jamba2-mini at its published widths on a card: one 8-layer stage served
through `launch.serve.serve` against the plain reference, and the
benchmark's jamba2-mini-stage.doc16k cell run once.  Every test here is
marked ``cuda`` and skips without a CUDA device.  The file imports neither
jax nor `repro`:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_jamba_cuda.py

(``--noconftest`` because `tests/conftest.py` imports jax).
"""
import gc
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
CELL = "jamba2-mini-stage.doc16k"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the stage at its published widths "
                    "runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_stage_served_at_1x4096_matches_the_reference(cuda_device):
    """The cell's driver at a 4096-token prompt and 8 new tokens: the
    logits of the prefill and of each decode step against the reference's
    teacher-forced forward, within the cell's limits."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.lib.harness import Context
    from portbench.lib.manifest import Manifest
    from portbench.lib.plugins import load_module

    bench = Manifest.load(ROOT)
    cell = bench.cell(CELL)
    config = bench.config(cell["config"])
    mix = dict(bench.mix(cell["traffic"]), prompt_tokens=4096, new_tokens=8,
               max_seq=4104)
    ctx = Context(CELL, 2 ** 31 + 11, config, mix, cuda_device)
    driver = load_module(bench.folder / "drivers", config["driver"]).make(
        bench.folder, ctx, io.StringIO())
    driver.setup(ctx)
    sample = driver.job(0)
    assert len(sample[1]) == 8 and tuple(sample[2].shape) == (8, 65536)
    err, margin = driver.compare(sample)
    del driver, sample
    gc.collect()
    torch.cuda.empty_cache()
    limits = config["limits"]
    assert err <= limits["max_rel_err"], err
    assert margin <= limits["route_margin"], margin


@pytest.mark.cuda
def test_cell_runs_once(cuda_device):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 13), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert {"job_ms", "setup_s"} <= set(result["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba2-mini", "jamba-1.5-large-398b"])
def test_graphed_decode_steps_equal_the_eager_ones(arch, cuda_device):
    """The hybrid family's decode step replayed from a CUDA graph
    (`Model.decode_graph`, as `serve` runs it) against the same steps run
    eagerly from a copy of the same cache: the logits, the cache and the
    dropless MoE's records bit for bit."""
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.models import Rules, build
    from repro_torch.models import moe

    bundle = configs.get(arch)
    model = build(reduced(bundle.model), bundle.parallel_for("decode_32k",
                                                             False))
    params = model.init(3, cuda_device)
    rules = Rules.make({"data": 1, "model": 1}, model.par)
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, 512, (2, 12), generator=gen, dtype=torch.int32)
    steps = torch.randint(0, 512, (5, 2, 1), generator=gen, dtype=torch.int32)
    cache = model.init_cache(2, 24, cuda_device)
    with torch.no_grad():
        model.prefill_fn(params, {"tokens": prompt.to(cuda_device)}, rules,
                         cache)
        eager = {k: v.clone() for k, v in cache.items()}
        step = model.decode_graph(params, cache, rules, 2)
        moe.DROPLESS.routes = []
        try:
            for t, toks in enumerate(steps):
                got = step(toks.numpy(), 12 + t).clone()
                routes = list(moe.DROPLESS.routes)
                moe.DROPLESS.routes = []
                want, eager = model.decode_fn(
                    params, {"tokens": toks.to(cuda_device), "pos": 12 + t},
                    eager, rules)
                assert torch.equal(got, want), t
                assert len(routes) == len(moe.DROPLESS.routes)
                assert all(torch.equal(a, b) for a, b in
                           zip(routes, moe.DROPLESS.routes))
                moe.DROPLESS.routes = []
        finally:
            moe.DROPLESS.routes = None
    for k in cache:
        assert torch.equal(cache[k], eager[k]), k
