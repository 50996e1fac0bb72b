"""The harness on the card (marked ``cuda``; each test skips where there is
no CUDA device): every cell run short and traced, a broken timed path at
the cell's size, and the control at the cell's size against its limit, by
the readings and through the harness's own check."""
from __future__ import annotations

import sys
import time

import pytest

from portbench.lib.harness import run_cell

from .conftest import ROOT, plant_control

CELLS = ["jacobi-2d-xl.fifo", "heat-3d-xl.fifo", "jacobi-2d-xl.buffer",
         "heat-3d-xl.buffer"]
pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", CELLS)
def test_cell_traced_on_card(card, cell):
    r = run_cell(ROOT, cell, 2 ** 31 + 77, 1.0, True, card,
                 time.perf_counter(), log=sys.stderr)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    kernel = "ring_roofline" if cell.endswith(".fifo") else \
        "addressable_roofline"
    assert set(m) == {"analysis_ms", "validate_ms", "launches_per_job",
                      kernel, "device_idle", "stencil_mfu"}
    assert m["launches_per_job"] == (250 if cell.endswith(".fifo") else 2000)
    assert 0 < m[kernel] <= 100 and 0 < m["stencil_mfu"] <= 100
    assert 0 <= m["device_idle"] < 100
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert r["device"]["busy_s"] <= r["device"]["window_s"]


@pytest.mark.parametrize("cell,target", [
    ("jacobi-2d-xl.fifo", "ring_stencil"),
    ("heat-3d-xl.buffer", "addressable_steps")])
def test_unchanged_state_on_card(card, cell, target, monkeypatch):
    """The kernel returns its input: the run is not correct."""
    from repro_torch.runtime import cuda_codegen

    monkeypatch.setattr(cuda_codegen, target,
                        lambda x, *args, **kwargs: x.clone())
    r = run_cell(ROOT, cell, 2 ** 31 + 78, 0.5, False, card,
                 time.perf_counter(), log=sys.stderr)
    assert r["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_on_card(card, cell):
    """At the cell's size, the program reads under its limit and the
    control (TF32 and bfloat16 levels) over it."""
    sys.path.insert(0, str(ROOT / "portbench"))
    import readings

    r = readings.readings(cell, [2 ** 31 + 79], [2 ** 31 + 79], device=card)
    assert r["lower"] <= r["limit"] < r["upper"]
    assert all(f > r["limit"] for s in r["faults"].values()
               for f in s.values())


@pytest.mark.parametrize("level", ["tf32", "bf16"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_through_the_harness_on_card(card, cell, level, monkeypatch):
    """The control in the program's place, run by the harness at the cell's
    size: `correct` is false, by ``max_rel_err``."""
    plant_control(monkeypatch, ROOT, cell, level)
    r = run_cell(ROOT, cell, 2 ** 31 + 80, 0.5, False, card,
                 time.perf_counter(), log=sys.stderr)
    print(f"{cell} {level}: max_rel_err "
          f"{r['checks']['max_rel_err']['value']!r}")
    assert r["correct"] is False and r["failed"] > 0
    assert not r["checks"]["max_rel_err"]["ok"]
