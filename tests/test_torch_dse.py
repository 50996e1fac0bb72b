"""The port's design-space exploration (`repro_torch.dse`) and H100 cost
model (`repro_torch.launch.roofline`) against the JAX package.

One small experiment (gemm, atax, jacobi-1d; tile sizes 2 and 4; both
topologies; 2 sizes) runs through both packages' services: the same spec
expands to the same ids and keys, the points agree on everything but the
roofline terms and the seconds, the frontiers over (fifo_fraction,
total_slots) agree, and a resume computes nothing.  The roofline prices the
same traffic with the card's constants.  The measured path's contract is
checked on the CPU: a measurement the device or geometry refuses is a note,
any other failure the point's error.
"""
import json
import tempfile

import pytest

import repro.dse as ref_dse
import repro_torch.dse as dse
from repro.launch.roofline import predict_report_cost as ref_cost
from repro_torch import device as h100
from repro_torch.dse.__main__ import main as dse_main
from repro_torch.launch.roofline import load, predict_report_cost


def tiny(pkg, **kw):
    kw.setdefault("kernels", ["gemm", "atax", "jacobi-1d"])
    kw.setdefault("tile_sizes", [2, 4])
    kw.setdefault("topologies", ["sequential", "pipeline"])
    kw.setdefault("size_count", 2)
    return pkg.default_experiment("tiny", **kw)


@pytest.fixture(scope="module")
def runs():
    """(reference service, its summary, port service, its summary)."""
    with tempfile.TemporaryDirectory() as d:
        out = []
        for pkg in (ref_dse, dse):
            svc = pkg.DSEService(tiny(pkg), pkg.ArtifactStore(
                f"{d}/{pkg.__name__}"), manager="inline")
            out += [svc, svc.run()]
        yield tuple(out)


def _points(svc) -> dict:
    return {p["key"]: p
            for p in svc.store.iter_points(svc.experiment.experiment_id)}


def _without_costs(point: dict) -> dict:
    doc = json.loads(json.dumps(point))
    for k in ("predicted_s", "roofline"):
        doc["metrics"].pop(k)
    for k in ("seconds", "template_build_s"):
        doc["provenance"].pop(k)
    return doc


def _front(points) -> set:
    """Per kernel, the points no other beats on (fifo_fraction, total_slots):
    {(kernel, key)}."""
    vec = {k: (p["metrics"]["fifo_fraction"], p["metrics"]["total_slots"])
           for k, p in points.items()}
    return {(p["kernel"], k) for k, p in points.items()
            if not any(points[o]["kernel"] == p["kernel"]
                       and vec[o][0] >= vec[k][0] and vec[o][1] <= vec[k][1]
                       and vec[o] != vec[k] for o in points)}


def test_same_spec_same_ids_and_point_keys():
    want, got = tiny(ref_dse), tiny(dse)
    assert got.as_dict() == want.as_dict()
    assert got.experiment_id == want.experiment_id
    assert [p.key for p in got.points()] == [p.key for p in want.points()]
    assert ([g.as_dict() for g in got.groups()]
            == [g.as_dict() for g in want.groups()])


def test_points_match_apart_from_costs_and_seconds(runs):
    ref_svc, ref_sum, svc, summary = runs
    assert summary["errors"] == ref_sum["errors"] == 0
    assert summary["computed"] == ref_sum["computed"] == 24
    got, want = _points(svc), _points(ref_svc)
    assert set(got) == set(want)
    for key in want:
        assert _without_costs(got[key]) == _without_costs(want[key]), key
    assert {p["provenance"]["size_mode"] for p in got.values()} >= {
        "parametric"}


def test_frontiers_over_fifo_fraction_and_slots_match(runs):
    ref_svc, _, svc, _ = runs
    assert _front(_points(svc)) == _front(_points(ref_svc))
    lines = svc.frontier_lines()
    assert [ln.split(", frontier")[0] for ln in lines] == [
        ln.split(", frontier")[0] for ln in ref_svc.frontier_lines()]


def test_resume_computes_nothing(runs):
    _, _, svc, _ = runs
    again = svc.run()
    assert again["computed"] == again["submitted"] == 0
    assert again["from_store"] == again["points_total"] == 24


# ------------------------------------------------------------- roofline ---


def test_roofline_prices_the_same_traffic_at_the_card_rates(runs):
    ref_svc, _, svc, _ = runs
    want = _points(ref_svc)
    for key, p in _points(svc).items():
        doc = p["report"]
        got, base = predict_report_cost(doc), ref_cost(doc)
        assert got["hbm_bytes"] == base["hbm_bytes"]
        assert got["smem_bytes"] == base["vmem_bytes"]
        edges = sum(int(c.get("edges", 0)) for c in doc["channels"])
        assert got["predicted_s"] == max(
            2 * edges / h100.PEAK_FLOPS_FP32,
            got["hbm_bytes"] / h100.HBM_BW + got["smem_bytes"] / h100.SMEM_BW)
        assert p["metrics"]["predicted_s"] == got["predicted_s"]
        assert want[key]["metrics"]["roofline"]["hbm_bytes"] \
            == got["hbm_bytes"]


def test_reorder_buffer_override_raises_device_memory_bytes(runs):
    _, _, svc, _ = runs
    doc = next(iter(_points(svc).values()))["report"]
    base = predict_report_cost(doc)
    forced = json.loads(json.dumps(doc))
    for plan in forced["plans"]:
        plan["lowering"] = "reorder-buffer"
    worse = predict_report_cost(forced)
    assert worse["hbm_bytes"] > base["hbm_bytes"]
    assert worse["smem_bytes"] < base["smem_bytes"]
    assert worse["predicted_s"] >= base["predicted_s"]


def test_roofline_load_warns_on_corrupt_record(tmp_path):
    (tmp_path / "good.json").write_text(json.dumps({"mesh": "16x16"}))
    (tmp_path / "bad.json").write_text("{truncated")
    with pytest.warns(UserWarning, match="bad.json"):
        recs, skipped = load(tmp_path)
    assert recs == [{"mesh": "16x16"}]
    assert skipped == [str(tmp_path / "bad.json")]


# ------------------------------------------------------ workers, managers --


def test_cli_worker_round_trip(tmp_path):
    task = tiny(dse).groups()[0]
    task_f, out_f = tmp_path / "task.json", tmp_path / "out.json"
    task_f.write_text(json.dumps(task.as_dict()))
    assert dse_main(["worker", "--task", str(task_f), "--out",
                     str(out_f)]) == 0
    results = json.loads(out_f.read_text())
    assert [r["key"] for r in results] == [p.key for p in task.points()]
    assert all("metrics" in r and "error" not in r for r in results)


def test_pool_manager_spawns_its_workers(runs):
    _, _, svc, _ = runs
    task = tiny(dse, kernels=["jacobi-1d"], tile_sizes=[2]).groups()[0]
    pool = dse.PoolManager(max_workers=1)
    try:
        assert pool._pool._mp_context.get_start_method() == "spawn"
        pool.submit(task.task_id, task.as_dict())
        (task_id, results), = list(pool.drain())
    finally:
        pool.close()
    assert task_id == task.task_id
    stored = _points(svc)
    for r in results:
        assert _without_costs(r) == _without_costs(stored[r["key"]])


def test_spec_with_interpret_is_refused():
    exp = tiny(dse, measure={"kernels": ["jacobi-1d"], "interpret": True})
    with pytest.raises(dse.SpecError, match="interpret"):
        exp.groups()
    exp = tiny(dse, measure={"kernels": ["jacobi-1d"], "device": "cpu"})
    measured = [g.measure for g in exp.groups() if g.measure]
    assert measured and all(m["device"] == "cpu" for m in measured)


def _measured_jacobi(device=None) -> dict:
    exp = tiny(dse, kernels=["jacobi-1d"], tile_sizes=[2],
               topologies=["sequential"],
               measure={"kernels": ["jacobi-1d"], "max_points": 1,
                        "device": device})
    return exp.groups()[0].as_dict()


@pytest.mark.parametrize("raised,device,outcome", [
    (RuntimeError("CUDA error: launch failed"), None, "error"),
    (ValueError("n_items 10 % block 4 != 0"), None, "note"),
    (None, "cpu", "note"),
], ids=["runtime-error", "value-error", "cpu-device"])
def test_measure_failure_is_an_error_and_a_refusal_a_note(
        raised, device, outcome, monkeypatch):
    from repro_torch.runtime import cuda_backend

    if raised is not None:
        def refuse(*args, **kwargs):
            raise raised
        monkeypatch.setattr(cuda_backend, "measure_compiled", refuse)
    results = dse.run_group(_measured_jacobi(device))
    first, rest = results[0], results[1:]
    assert all("error" not in r and "measured" not in r for r in rest)
    assert "measured" not in first
    if outcome == "error":
        assert first["error"] == {"type": "RuntimeError",
                                  "message": "CUDA error: launch failed"}
        return
    assert "error" not in first
    notes = [n for n in first["provenance"]["notes"]
             if n.startswith("measure skipped: ValueError")]
    assert len(notes) == 1
    assert ("n_items" if raised is not None else "'cpu'") in notes[0]
