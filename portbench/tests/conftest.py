"""Fixtures of the harness's tests: a copy of the benchmark with tiny
configurations beside the real ones, run on the CPU through the port's
plain versions."""
from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

#: tiny shapes the CPU runs: (config, program, shape, sweeps)
TINY = (("jacobi-2d-tiny", "jacobi-2d", [16, 16], 16),
        ("heat-3d-tiny", "heat-3d", [8, 8, 8], 16))
#: small shapes at the cells' 2000 sweeps, where the lower-precision
#: control's error has grown past the limit (at 16 sweeps it has not)
LONG = (("jacobi-2d-long", "jacobi-2d", [32, 32], 2000),
        ("heat-3d-long", "heat-3d", [16, 16, 16], 2000))
MIXES = ("fifo", "buffer")


def tiny_cells(configs=TINY):
    return [f"{config}.{mix}" for config, *_ in configs for mix in MIXES]


def make_copy(dest: Path, configs=TINY) -> Path:
    """A copy of `BENCHMARK.json` and ``portbench/`` at ``dest`` with the
    program linked in, and ``configs`` added as files and entries (no file
    of the copy edited but `BENCHMARK.json`)."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", dest / "src")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for name, program, shape, sweeps in configs:
        real = json.loads((ROOT / "portbench" / "configs" /
                           f"{program}-xl.json").read_text())
        real.update(name=name, shape=shape, sweeps=sweeps)
        (dest / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(real))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        for mix in MIXES:
            cell = f"{name}.{mix}"
            bench["workloads"].append({"name": cell, "config": name,
                                       "traffic": mix, "chips": 1,
                                       "why": "test"})
            for m in bench["per_layer"]:
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="session")
def long_root(tmp_path_factory) -> Path:
    return make_copy(tmp_path_factory.mktemp("bench-long"), LONG)


def plant_control(monkeypatch, root: Path, cell: str, level: str) -> None:
    """The control in the program's place: the kernel under the cell's
    `CompiledStencil` replaced by the program's reference at ``root``, run
    with each sweep's input rounded to ``level`` (`lib.compare.CONTROLS`).
    """
    from portbench.lib.compare import CONTROLS, sweeps
    from portbench.lib.manifest import Manifest
    from portbench.lib.plugins import load_module
    from repro_torch.runtime import cuda_codegen

    bench = Manifest.load(root)
    program = bench.config(bench.cell(cell)["config"])["program"]
    ref = load_module(bench.folder / "reference", program)

    def control(x, program, steps, *args):
        return sweeps(ref.sweep, x, steps, CONTROLS[level])

    target = "ring_stencil" if cell.endswith(".fifo") else \
        "addressable_steps"
    monkeypatch.setattr(cuda_codegen, target, control)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
