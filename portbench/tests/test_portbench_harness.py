"""The harness run on the CPU through the port's plain versions, on tiny
copies of the configurations: a sound run is correct and reports its
metrics; a run with the timed path broken underneath is not; files added
by name are found with no edit; nothing of the JAX stack or the reference
package is loaded; and `run.py` refuses to run without a card or without
the program."""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from portbench.lib.harness import ForbiddenModules, forbidden_modules, run_cell

from .conftest import LONG, ROOT, make_copy, plant_control, tiny_cells

CPU = torch.device("cpu")


def run(root: Path, cell: str, trace: bool = False, seed: int = 2 ** 31 + 9,
        seconds: float = 0.2) -> dict:
    return run_cell(root, cell, seed, seconds, trace, CPU,
                    time.perf_counter(), log=sys.stderr)


@pytest.mark.parametrize("cell", tiny_cells())
def test_sound_run(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "job_ms"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert r["checks"]["max_rel_err"]["ok"]
    json.dumps(r)


@pytest.mark.parametrize("cell", ["jacobi-2d-tiny.fifo",
                                  "heat-3d-tiny.buffer"])
def test_traced_run(tiny_root, cell):
    """A traced run reads the host spans; on the CPU no device operation
    ran, so the readers of the device trace and of the kernels' counters
    return nothing and their metrics are left out, never 0."""
    r = run(tiny_root, cell, trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"analysis_ms", "validate_ms"}
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(x, *args, **kwargs):
    return x.clone()


def _half_left_out(real):
    def broken(x, *args, **kwargs):
        y = real(x, *args, **kwargs)
        y[y.shape[0] // 2:] = x[x.shape[0] // 2:]
        return y
    return broken


def _narrow_exchange(real):
    def broken(x, program, steps, block, ring_depth, halo):
        return real(x, program, steps, block, ring_depth, 1)
    return broken


def _altered(real):
    def broken(x, *args, **kwargs):
        y = real(x, *args, **kwargs)
        y.view(-1)[y.numel() // 3] += 0.5
        return y
    return broken


FAULTS = {"unchanged": lambda real: _unchanged,
          "half_left_out": _half_left_out,
          "exchange_left_out": _narrow_exchange,
          "answer_altered": _altered}


#: (cell, fault): the exchange between blocks (the ring's channel,
#: narrowed to one item) exists on the ring path only
BROKEN = [(cell, fault) for cell in tiny_cells() for fault in sorted(FAULTS)
          if cell.endswith(".fifo") or fault != "exchange_left_out"]


@pytest.mark.parametrize("cell,fault", BROKEN)
def test_broken_path_is_not_correct(tiny_root, cell, fault, monkeypatch):
    """The kernel under the `CompiledStencil` broken: the run completes
    and `correct` is false."""
    from repro_torch.runtime import cuda_codegen

    target = ("ring_stencil" if cell.endswith(".fifo")
              else "addressable_steps")
    real = getattr(cuda_codegen, target)
    monkeypatch.setattr(cuda_codegen, target, FAULTS[fault](real))
    r = run(tiny_root, cell)
    assert r["correct"] is False and r["failed"] > 0
    assert not r["checks"]["max_rel_err"]["ok"]


@pytest.mark.parametrize("level", ["tf32", "bf16"])
@pytest.mark.parametrize("cell", tiny_cells(LONG))
def test_control_is_not_correct(long_root, cell, level, monkeypatch):
    """The control (the reference at a lower precision in the program's
    place) run through the harness at the cells' sweeps: `correct` is
    false, by ``max_rel_err``."""
    plant_control(monkeypatch, long_root, cell, level)
    r = run(long_root, cell)
    assert r["correct"] is False and r["failed"] > 0
    assert not r["checks"]["max_rel_err"]["ok"]


def test_not_the_cells_traffic(tiny_root, monkeypatch):
    """A fifo cell whose plan the program does not run through the ring
    fails: the job is not the cell's traffic."""
    from repro_torch.runtime import cuda_codegen, lowering

    real = cuda_codegen.compile_analysis
    monkeypatch.setattr(lowering.backend("cuda"), "compile",
                        lambda a, mode=None, device=None:
                        real(a, mode="addressable", device=device))
    with pytest.raises(RuntimeError, match="the cell measures 'fifo-ring'"):
        run(tiny_root, "jacobi-2d-tiny.fifo")


def test_forbidden_modules(tiny_root, monkeypatch):
    before = forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_x", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "reproduce", types.ModuleType("x"))
    assert forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    assert "flax" in forbidden_modules()
    with pytest.raises(ForbiddenModules):
        run(tiny_root, "jacobi-2d-tiny.buffer")


def with_flax_reader(root: Path) -> Path:
    """``root`` with a stub `flax` package beside it and a metric reader,
    listed for the tiny jacobi-2d buffer cell, that imports it."""
    stub = root / "stub" / "flax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    (root / "portbench" / "metrics" / "loads_flax.py").write_text(
        "def read(ctx):\n    import flax  # noqa: F401\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "loads_flax", "unit": "1",
                               "better": "lower", "source": "host_clock",
                               "layer": "test", "moves": "job_ms",
                               "workloads": ["jacobi-2d-tiny.buffer"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root / "stub"


def test_forbidden_module_loaded_by_a_reader(tmp_path, monkeypatch):
    """A metric's reader runs after the window and the check; what it
    loads is still looked for before a result is given."""
    root = make_copy(tmp_path / "bench")
    monkeypatch.syspath_prepend(str(with_flax_reader(root)))
    monkeypatch.delitem(sys.modules, "flax", raising=False)
    try:
        with pytest.raises(ForbiddenModules, match="flax"):
            run(root, "jacobi-2d-tiny.buffer", trace=True)
    finally:
        sys.modules.pop("flax", None)


FAKE_CARD = """
import sys, time
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [sys.argv[2], str(root / "src"), str(root)]
import importlib.util
import torch
spec = importlib.util.spec_from_file_location(
    "run", root / "portbench" / "run.py")
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
import portbench.lib.harness as harness
real = harness.run_cell
def on_cpu(root, workload, seed, seconds, trace, device, t0, **kw):
    return real(root, workload, seed, seconds, trace, torch.device("cpu"),
                t0, **kw)
harness.run_cell = on_cpu
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
sys.exit(run.main(["--workload", "jacobi-2d-tiny.buffer", "--seed", "7",
                   "--seconds", "0.1", "--trace", "1"]))
"""


def test_run_py_exits_3_when_a_reader_loads_flax(tmp_path):
    """`run.py` prints no result and exits 3 where a reader loaded a
    module of the JAX stack (the card faked, the run made on the CPU)."""
    root = make_copy(tmp_path / "bench")
    stub = with_flax_reader(root)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", FAKE_CARD, str(root),
                        str(stub)], capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode == 3, p.stderr[-2000:]
    assert p.stdout.strip() == "" and "flax" in p.stderr


def digests(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_files_found_by_name(tmp_path):
    """A configuration, a mix and a metric added as new files, with entries
    in `BENCHMARK.json`, run with no edit to any file that was there."""
    root = make_copy(tmp_path / "bench")
    before = digests(root / "portbench")
    folder = root / "portbench"
    config = json.loads((folder / "configs" / "jacobi-2d-xl.json").read_text())
    config.update(name="jacobi-2d-odd", shape=[24, 16], sweeps=8)
    (folder / "configs" / "jacobi-2d-odd.json").write_text(json.dumps(config))
    mix = json.loads((folder / "mixes" / "fifo.json").read_text())
    mix.update(steps_per_call=4)
    (folder / "mixes" / "fifo4.json").write_text(json.dumps(mix))
    (folder / "metrics" / "jobs_done.py").write_text(
        "def read(ctx):\n    return ctx.jobs\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "jacobi-2d-odd", "source": "test",
                             "file": "portbench/configs/jacobi-2d-odd.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "jacobi-2d-odd.fifo4",
                               "config": "jacobi-2d-odd", "traffic": "fifo4",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "job_ms",
                               "workloads": ["jacobi-2d-odd.fifo4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(root, "jacobi-2d-odd.fifo4", trace=True)
    assert r["correct"] and r["metrics"]["jobs_done"]["value"] > 0
    after = digests(folder)
    assert {k: after[k] for k in before} == before


CHILD = """
import sys, time, json
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
import importlib.util
spec = importlib.util.spec_from_file_location(
    "run", root / "portbench" / "run.py")
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
from portbench.lib.harness import run_cell
import torch
r = run_cell(root, "jacobi-2d-tiny.fifo", 5, 0.1, True, torch.device("cpu"),
             time.perf_counter())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_loaded(tiny_root):
    """Nothing a run loads is of the JAX stack or the reference package,
    compared by whole top-level names."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", CHILD, str(tiny_root)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True).stdout
    names = set(json.loads(out.strip().splitlines()[-1]))
    assert "repro_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def _run_py(root: Path, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(root / "portbench" / "run.py"), "--workload",
         "jacobi-2d-xl.fifo", "--seed", str(2 ** 31 + 1), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=root,
        env=dict(os.environ, **env), timeout=300)


def test_no_card_no_result():
    p = _run_py(ROOT, CUDA_VISIBLE_DEVICES="")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_no_program_no_result(tmp_path):
    """In a directory that holds only `BENCHMARK.json` and the files under
    its paths, the command exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
