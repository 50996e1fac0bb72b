"""The served-request driver (`drivers/hybrid_request.py`) on the CPU through
the port's plain path, on a tiny copy of the jamba2-mini-stage
configuration: a sound run is correct and reports its metrics, traced and
not; the controls at a lower precision of the scan fail the limit; the
published keys are held to the registered model; and a checkout without
the model stops before any weight is drawn."""
from __future__ import annotations

import dataclasses
import io
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.lib.harness import Context, run_cell
from portbench.lib.manifest import Manifest
from portbench.lib.plugins import load_module

from .conftest import ROOT, make_copy

CPU = torch.device("cpu")
CELL = "jamba2-mini-stage.doc16k"
TINY = "jamba2-mini-tiny"
#: the tiny model's published keys (the rest are the real file's)
WIDTHS = {"hidden_size": 64, "intermediate_size": 128,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "vocab_size": 512, "num_experts": 4, "mamba_dt_rank": 8}


def register_tiny():
    from repro_torch import configs
    from repro_torch.configs.base import ArchBundle, ParallelConfig

    model = dataclasses.replace(
        configs.get("jamba2-mini").model, name=TINY, num_layers=16,
        d_model=64, d_ff=128, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=512, num_experts=4, ssm_dt_rank=8)
    configs.register_published(ArchBundle(model, {"": ParallelConfig()}))


def make_hybrid_copy(dest: Path) -> Path:
    """A copy of the benchmark with a tiny jamba2-mini stage, cell
    ``tiny.doc48``: prompts of 48 tokens, 5 new."""
    register_tiny()
    dest = make_copy(dest, ())
    folder = dest / "portbench"
    real = json.loads((folder / "configs" / "jamba2-mini-stage.json")
                      .read_text())
    # the tiny model's own limits, from its readings (see the fp8 test)
    real.update(WIDTHS, name="jamba2-mini-tiny-stage", program=TINY,
                num_hidden_layers=16,
                limits={"max_rel_err": 0.15, "route_margin": 0.03})
    (folder / "configs" / "jamba2-mini-tiny-stage.json").write_text(
        json.dumps(real))
    mix = json.loads((folder / "mixes" / "doc16k.json").read_text())
    mix.update(prompt_tokens=48, new_tokens=5, max_seq=56)
    (folder / "mixes" / "doc48.json").write_text(json.dumps(mix))
    (folder / "reference" / f"{TINY}.py").write_text(
        (folder / "reference" / "jamba2-mini.py").read_text())
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "jamba2-mini-tiny-stage",
                             "source": "test",
                             "file": "portbench/configs/"
                                     "jamba2-mini-tiny-stage.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.doc48",
                               "config": "jamba2-mini-tiny-stage",
                               "traffic": "doc48", "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        if CELL in m["workloads"]:
            m["workloads"].append("tiny.doc48")
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="module")
def hybrid_root(tmp_path_factory) -> Path:
    return make_hybrid_copy(tmp_path_factory.mktemp("bench-hybrid"))


def run(root: Path, cell: str, trace: bool = False, seed: int = 2 ** 31 + 9,
        seconds: float = 0.2) -> dict:
    return run_cell(root, cell, seed, seconds, trace, CPU,
                    time.perf_counter(), log=sys.stderr)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run(hybrid_root, trace):
    r = run(hybrid_root, "tiny.doc48", trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    # the device's metrics read nothing where no device ran
    want = {"decode_step_ms"} if trace else {"setup_s", "job_ms"}
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["checks"]["dropped_assignments"]["value"] == 0
    assert r["checks"]["routed_per_request"]["ok"]


def driver(root: Path, cell: str = "tiny.doc48", seed: int = 5):
    bench = Manifest.load(root)
    entry = bench.cell(cell)
    config = bench.config(entry["config"])
    ctx = Context(cell, seed, config, bench.mix(entry["traffic"]), CPU)
    return load_module(bench.folder / "drivers", config["driver"]).make(
        bench.folder, ctx, io.StringIO()), ctx, config


def test_fp8_control_fails_where_the_program_passes(hybrid_root):
    """At the tiny size the program (bf16) reads 0.03–0.09 and under 0.01
    over seeds 0–5, the reference with its activations in float8 e4m3
    (the precision below bf16) 0.24–0.76 and 0.11–0.20."""
    from portbench.lib.compare import max_rel_err

    d, ctx, config = driver(hybrid_root)
    d.setup(ctx)
    prompt, tokens, logits, calls = sample = d.job(0)
    err, margin = d.compare(sample)
    routes = d.layer_routes(calls)
    want = d.reference_logits(prompt, tokens, routes)
    fp8 = load_module(hybrid_root / "portbench", "readings_hybrid").fp8
    control = max_rel_err(d.reference_logits(prompt, tokens, routes,
                                             level=fp8), want)
    own = {}
    d.reference_logits(prompt, tokens, level=fp8, record=own)
    forced = {}
    d.reference_logits(prompt, tokens, own["routes"], record=forced)
    assert err < 0.12 < 0.2 < control
    assert margin < 0.02 < 0.05 < forced["margin"]


def test_published_keys_are_held_to_the_registered_model(hybrid_root):
    bench = Manifest.load(hybrid_root)
    module = load_module(bench.folder / "drivers", "hybrid_request")
    from repro_torch import configs
    config = bench.config("jamba2-mini-stage")
    cfg = module.model_config(configs.get("jamba2-mini").model, config)
    assert cfg.num_layers == 8 and cfg.d_model == 4096
    for key, value in (("mamba_dt_rank", 160), ("num_experts_per_tok", 1),
                       ("attn_layer_offset", 3), ("rms_norm_eps", 1e-5),
                       ("num_hidden_layers", 28)):
        with pytest.raises(module.NotTheModel):
            module.model_config(configs.get("jamba2-mini").model,
                                {**config, key: value})


def test_a_checkout_without_the_model_stops_before_drawing(hybrid_root,
                                                         monkeypatch):
    from repro_torch.models import common

    def draw(*a, **k):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(common, "init_params", draw)
    from repro_torch import configs
    monkeypatch.delitem(configs._PUBLISHED, "jamba2-mini")
    with pytest.raises(KeyError):
        run(ROOT, CELL)


def test_work_counts_the_stage_at_the_published_widths():
    bench = Manifest.load(ROOT)
    ref = load_module(bench.folder / "reference", "jamba2-mini")
    w = ref.work(bench.config("jamba2-mini-stage"), 16384, 32)
    assert abs(w["weight_bytes"] / 2 - 13.295e9) < 1e6
    assert 100e12 < w["flops"] < 110e12
