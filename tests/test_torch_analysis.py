"""The port's analysis path (`src/repro_torch/`) against the JAX package.

1. Isolation: the port imports neither jax nor `repro`; a subprocess with
   both blocked runs the whole main path (the self-timed and fault modes
   and the self-timed CLI included), the Fig. 3, attention and time-mix
   entry points, a symbolic template, one DSE group, the pipeline ring
   and the optimizers, on the CPU.
2. Report parity: on all 15 PolyBench kernels,
   ``classify → fifoize → size → plan → validate → report`` gives the same
   `AnalysisReport` in both packages (apart from the cache counters).
3. Plan records cross over: the port reads the reference's report JSON
   (schema 5) into an equal report.
4. The slice boundary: the self-timed and fault modes run, and the
   registry holds the four backends.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.core.polybench  # noqa: F401,E402  (populate the registry)
import repro_torch.core.polybench  # noqa: F401,E402
from repro.core import analyze as ref_analyze  # noqa: E402
from repro.core.registry import get as ref_get, kernel_names  # noqa: E402
from repro_torch.core import (AnalysisReport, ParametricAnalysis,  # noqa: E402
                              analyze)
from repro_torch.core.registry import get  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _payload(report) -> dict:
    doc = report.as_dict()
    doc.pop("cache")
    return doc


# ------------------------------------------------------------ isolation ----


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        bad = {m for m in _imported_roots(path) if m in ("jax", "repro")}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


_BLOCKED_MAIN_PATH = r"""
import importlib.abc, sys
sys.modules["jax"] = None

class RefuseRepro(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, RefuseRepro())
import numpy as np
import repro_torch.core.polybench
from repro_torch.core import analyze
from repro_torch.core.registry import get

a = analyze(get("jacobi-1d")).classify().fifoize().size().plan()
c = a.compile(device="cpu")
assert c.mode == "fifo-ring", c.describe()
x = np.random.default_rng(0).standard_normal(32).astype(np.float32)
got = c(x, 4, 4)
assert float((got - c.program.ref(got.new_tensor(x), 4)).abs().max()) < 1e-5
v = a.validate(backend="cuda", device="cpu").validation
assert (v.replays, v.rejections) == (14, 3), v.summary()
assert a.validate(mode="selftimed").selftimed.report.completed
r = a.validate(mode="faults", device="cpu").resilience
assert r.trace_backends == ["reference", "cuda"], r.trace_backends
from repro_torch.comm.planner import PipelineSpec, ring_selftimed
assert ring_selftimed(PipelineSpec(4, 6, 2, "vpp-blocked")).completed
from repro_torch.runtime.selftimed.__main__ import main as selftimed_cli
assert selftimed_cli(["--decode", "--slots", "2", "--steps", "3"]) == 0
import repro_torch.bench.selftimed_points

import torch
import repro_torch.bench.fig3_stencil
from repro_torch.kernels.flash_attention import attention_op
from repro_torch.kernels.gla_timemix import timemix_op
from repro_torch.kernels.stencil_fifo import jacobi_fifo_op

rng = np.random.default_rng(1)
t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(
    np.float32))
assert jacobi_fifo_op(t(32), 4, 4).shape == (32,)
q, k = t(1, 128, 4, 16), t(1, 128, 2, 16)
assert attention_op(q, k, k, causal=True, use_kernel=True).shape == q.shape
r = t(1, 32, 2, 16)
assert timemix_op(r, r, r, -r.abs(), t(2, 16), chunk=16,
                  use_kernel=True).shape == r.shape
from repro_torch.core import symbolic
pa = analyze(get("jacobi-1d"), sizes=symbolic).classify().fifoize().size()
pa = pa.plan()
assert pa.evaluate(N=20, T=12).params == {"N": 20, "T": 12}
assert pa.status == "symbolic", pa.status
from repro_torch.dse import default_experiment, run_group
task = default_experiment("blocked", kernels=["jacobi-1d"], tile_sizes=[2],
                          topologies=["sequential"], size_count=2,
                          measure={"kernels": ["jacobi-1d"], "max_points": 1,
                                   "device": "cpu"}).groups()[0]
rows = run_group(task.as_dict())
assert [r["provenance"]["size_mode"] for r in rows] == ["parametric"] * 2
assert "measure skipped" in rows[0]["provenance"]["notes"][0], rows[0]
from repro_torch.comm import (LocalGroup, PipelineSpec, analyze_pipeline,
                              pipeline_loss_fn, stage_params)
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.compression import compressed_psum_mean
group = LocalGroup(4, "cpu")
_, plans = analyze_pipeline(PipelineSpec(stages=4, microbatches=3))
params = stage_params({"w": 0.5 * rng.standard_normal((4, 8, 8)),
                       "b": np.zeros((4, 8))}, group)
loss = pipeline_loss_fn(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                        lambda h, y: torch.mean((h - y) ** 2), group,
                        plans=plans)(params, t(3, 2, 8).double(),
                                     t(3, 2, 8).double())
assert loss.ndim == 0 and bool(torch.isfinite(loss))
g = t(4, 16)
mean, err = compressed_psum_mean(g, torch.zeros_like(g), group)
assert float((mean - g.mean(0)).abs().max()) <= float(g.abs().max()) / 127
p = {"w": t(4, 8, 8)}
new, opt, gnorm = adamw_update(p, {"w": t(4, 8, 8)},
                               adamw_init(p, "int8"), 1e-2,
                               state_dtype="int8")
assert int(opt["step"]) == 1 and new["w"].shape == (4, 8, 8)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "repro") and sys.modules[m])
assert not leaked, leaked
print("main path ok")
"""


def test_main_path_runs_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_MAIN_PATH],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "main path ok" in proc.stdout


def test_chip_smoke_refuses_to_run_without_a_card():
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# --------------------------------------------------------- report parity ---


@pytest.mark.parametrize("name", kernel_names())
def test_report_parity_with_reference(name):
    want = (ref_analyze(ref_get(name)).classify().fifoize().size().plan()
            .validate(backend="reference").report())
    got = (analyze(get(name)).classify().fifoize().size().plan()
           .validate(backend="reference").report())
    assert _payload(got) == _payload(want)


def test_reference_report_json_round_trips_into_the_port():
    want = (ref_analyze(ref_get("jacobi-2d")).classify().fifoize().size()
            .plan().validate().report())
    text = want.to_json()
    got = AnalysisReport.from_json(text)
    assert got.schema_version == 5
    assert got.as_dict() == json.loads(text)
    assert got.to_json() == text


# ------------------------------------------------------- slice boundary ----


def test_unported_modes_name_their_roadmap_item():
    """The self-timed and fault modes, once refused, now run: the
    self-timed evidence and the fault matrix's reference rows are the
    reference's, and the port's wire faults also replay on "cuda"."""
    a = analyze(get("jacobi-1d")).classify().fifoize().size().plan()
    ref = ref_analyze(ref_get("jacobi-1d")).classify().fifoize().size().plan()
    st = a.validate(mode="selftimed")
    assert st.selftimed.as_dict() == (ref.validate(mode="selftimed")
                                      .selftimed.as_dict())
    faults = a.validate(mode="faults", device="cpu").resilience
    want = ref.validate(mode="faults").resilience
    assert faults.trace_backends == ["reference", "cuda"]
    assert faults.matrix == want.matrix
    rows = {b: [r for r in faults.trace_matrix if r["backend"] == b]
            for b in ("reference", "cuda")}
    assert rows["reference"] == want.trace_matrix
    assert len(rows["cuda"]) == len(want.trace_matrix) == 10
    assert all(r["detected"] for r in rows["cuda"])
    with pytest.raises(ValueError, match="faults"):
        a.validate(mode="nonsense")
    assert isinstance(analyze(get("jacobi-1d"), sizes="symbolic"),
                      ParametricAnalysis)
    with pytest.raises(ValueError, match="symbolic"):
        analyze(get("jacobi-1d"), sizes="bogus")
    assert analyze(get("jacobi-1d"), sizes={"N": 12}).ppn.params["N"] == 12


def test_backends_register_without_a_card():
    from repro_torch.runtime import available_backends

    status = available_backends()
    assert set(status) == {"reference", "cuda", "selftimed", "torch"}
    assert all(s.startswith("ok") for s in status.values()), status
    assert "+compile" in status["cuda"]
    assert "+compile" in status["selftimed"]
