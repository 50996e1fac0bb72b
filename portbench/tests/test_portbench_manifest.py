"""`BENCHMARK.json` against the benchmark's contract: keys, names, units,
lengths, the cells, what each per-layer metric moves, and a file for every
configuration, mix and metric."""
from __future__ import annotations

import json
import re

import pytest

from portbench.lib.manifest import Manifest
from portbench.lib.plugins import checked_name

from .conftest import ROOT

KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer")
SOURCES_END_TO_END = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")

UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
CELLS = ["jacobi-2d-xl.fifo", "heat-3d-xl.fifo", "jacobi-2d-xl.buffer",
         "heat-3d-xl.buffer"]
#: what a width is named like: never in `reduced`
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan"
                   r"|_dim$|_rank$|per_tok)", re.I)


@pytest.fixture(scope="module")
def bench() -> Manifest:
    return Manifest.load(ROOT)


def all_names(bench: Manifest) -> list:
    """Every name of the manifest that must be a benchmark name."""
    d = bench.data
    out = [c["name"] for c in d["configs"]]
    for c in d["configs"]:
        out += c["reduced"]
    for w in d["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    return out + [m["name"] for m in d["end_to_end"] + d["per_layer"]]


def test_keys_command_and_paths(bench):
    d = bench.data
    assert tuple(d) == KEYS
    assert d["command"] == ["python3", "portbench/run.py"]
    assert d["paths"] == ["portbench"]
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines(bench):
    d = bench.data
    names = all_names(bench)
    assert all(NAME.match(n) and checked_name(n) for n in names), names
    for group in ("configs", "workloads"):
        listed = [e["name"] for e in d[group]]
        assert len(listed) == len(set(listed))
    metrics = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    lines = ([c["why"] for c in d["configs"]] + [c["source"] for c in
             d["configs"]] + [w["why"] for w in d["workloads"]]
             + [m["layer"] for m in d["per_layer"]] + d["command"])
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_their_keys(bench):
    d = bench.data
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_END_TO_END
        assert 0.01 <= m["bound"] <= 0.25
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_cells_in_order_on_one_chip(bench):
    d = bench.data
    assert [w["name"] for w in d["workloads"]] == CELLS
    assert all(w["chips"] == 1 for w in d["workloads"])
    assert {c["name"] for c in d["configs"]} == {"jacobi-2d-xl", "heat-3d-xl"}
    used = {w["config"] for w in d["workloads"]}
    assert used == {c["name"] for c in d["configs"]}


def test_end_to_end_metrics(bench):
    e2e = {m["name"]: m for m in bench.data["end_to_end"]}
    assert set(e2e) == {"setup_s", "job_ms"}
    assert e2e["setup_s"]["bound"] == 0.25
    for cell in CELLS:
        assert {m["name"] for m in bench.end_to_end(cell)} == set(e2e)


def test_per_layer_moves_what_its_cells_report(bench):
    """Every per-layer metric moves an end-to-end metric that each of its
    cells reports, and every cell reports one per-layer metric or more."""
    cells = {w["name"] for w in bench.data["workloads"]}
    for m in bench.data["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in bench.end_to_end(cell)}
    for cell in cells:
        assert bench.per_layer(cell)
    by_name = {m["name"]: m for m in bench.data["per_layer"]}
    assert set(by_name) == {"analysis_ms", "validate_ms", "launches_per_job",
                            "ring_roofline", "addressable_roofline",
                            "device_idle", "stencil_mfu"}
    assert set(by_name["ring_roofline"]["workloads"]) == {
        "jacobi-2d-xl.fifo", "heat-3d-xl.fifo"}
    assert set(by_name["addressable_roofline"]["workloads"]) == {
        "jacobi-2d-xl.buffer", "heat-3d-xl.buffer"}
    for name, m in by_name.items():
        if name.endswith("_roofline") or "mfu" in name:
            assert m["unit"] == "%"


def test_every_name_has_its_file(bench):
    for cell in bench.data["workloads"]:
        bench.config_entry(cell["config"])
        bench.mix(cell["traffic"])
    for m in bench.data["end_to_end"] + bench.data["per_layer"]:
        assert (bench.folder / "metrics" / f"{m['name']}.py").is_file(), m
    files = [c["file"] for c in bench.data["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("portbench/") and (ROOT / f).is_file()


def test_configs_list_their_changes(bench):
    for entry in bench.data["configs"]:
        config = bench.config(entry["name"])
        assert config["name"] == entry["name"]
        assert config["assumed"]
        for key in entry["reduced"]:
            assert key in config and not WIDTH.search(key)
        assert (ROOT / "portbench" / "reference" /
                f"{config['program']}.py").is_file()
        assert (ROOT / "portbench" / "drivers" /
                f"{config['driver']}.py").is_file()
        json.dumps(config)
