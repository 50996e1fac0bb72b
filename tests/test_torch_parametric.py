"""Parametric analysis and tile sweeps in the port (`repro_torch.core.
parametric`, `repro_torch.core.sweep`) against the JAX package.

The same kernels go through both packages: the symbolic template of gemm
and jacobi-1d (status, proofs, capacity closed forms, evaluated payloads on
the proved lattice, the loud fallback off it), and the sweep engine's
reports and per-configuration error contract.  The kernels are ones whose
templates build in well under a second (`BENCH_parametric.json`: gemm
0.63 s), so the file stays cheap.
"""
import json
import sys
import warnings

import pytest

import repro.core as ref
import repro.core.polybench  # noqa: F401  (populate the registry)
import repro_torch.core as port
import repro_torch.core.polybench  # noqa: F401
from repro.core.registry import get as ref_get
from repro.core.tiling import rescale_tilings as ref_rescale
from repro_torch.core.registry import get
from repro_torch.core.tiling import rescale_tilings


def _dumps(doc) -> str:
    return json.dumps(doc, sort_keys=True)


def _template(pkg, getter, name):
    pa = (pkg.analyze(getter(name), sizes=pkg.symbolic)
          .classify().fifoize().size().plan())
    with warnings.catch_warnings():
        warnings.simplefilter("error", pkg.ParametricFallbackWarning)
        pa.prepare()
    return pa


@pytest.fixture(scope="module", params=["gemm", "jacobi-1d"])
def templates(request):
    """(name, reference template, port template), both closed."""
    want = _template(ref, ref_get, request.param)
    got = _template(port, get, request.param)
    yield request.param, want, got
    want.release()
    got.release()


def _lattice(pa, k: int) -> dict:
    t = pa._template
    return {p: t["theta"][p] + k * t["strides"][p]
            for p in pa.symbolic_params}


def test_template_status_proofs_and_capacities_match(templates):
    _, want, got = templates
    assert isinstance(got, port.ParametricAnalysis)
    assert got.status == want.status == "symbolic"
    assert got.symbolic_params == want.symbolic_params
    assert ({k: str(p) for k, p in got.closed_forms().items()}
            == {k: str(p) for k, p in want.closed_forms().items()})
    # the whole report at the default sizes, parametric section included
    assert (_dumps(port.report_payload(got.report()))
            == _dumps(ref.report_payload(want.report())))


def test_evaluate_matches_reference_on_the_lattice(templates):
    name, want, got = templates
    for k in (0, 1, 2):
        env = _lattice(want, k)
        assert _lattice(got, k) == env
        with warnings.catch_warnings():
            warnings.simplefilter("error", port.ParametricFallbackWarning)
            warnings.simplefilter("error", ref.ParametricFallbackWarning)
            ev = port.report_payload(got.evaluate(**env))
            ev_ref = ref.report_payload(want.evaluate(**env))
        assert _dumps(ev) == _dumps(ev_ref), f"{name} at {env}"


def test_off_lattice_size_falls_back_loudly_in_both(templates):
    name, want, got = templates
    first = want.symbolic_params[0]
    env = dict(_lattice(want, 1))
    env[first] += 1                 # every stride here is 4: off the lattice
    assert want._template["strides"][first] > 1
    with pytest.warns(ref.ParametricFallbackWarning):
        ev_ref = ref.report_payload(want.evaluate(**env))
    with pytest.warns(port.ParametricFallbackWarning):
        ev = port.report_payload(got.evaluate(**env))
    assert _dumps(ev) == _dumps(ev_ref), f"{name} at {env}"


# ------------------------------------------------------------------ sweeps --


@pytest.mark.parametrize("sizes", [None, {"N": [12, 20]}],
                         ids=["tilings", "tilings-x-sizes"])
def test_sweep_reports_match_reference(sizes):
    cfgs = [dict(get("atax").tilings), rescale_tilings(get("atax").tilings, 2)]
    ref_cfgs = [dict(ref_get("atax").tilings),
                ref_rescale(ref_get("atax").tilings, 2)]
    with warnings.catch_warnings():     # an off-lattice size falls back in
        warnings.simplefilter("ignore")     # both; the reports still agree
        got = port.sweep(get("atax"), cfgs, sizes=sizes)
        want = ref.sweep(ref_get("atax"), ref_cfgs, sizes=sizes)
    assert len(got) == len(want) == len(cfgs) * (2 if sizes else 1)
    assert ([_dumps(port.report_payload(r)) for r in got]
            == [_dumps(ref.report_payload(r)) for r in want])


def test_run_job_matches_reference():
    tilings = (dict(get("jacobi-1d").tilings),
               rescale_tilings(get("jacobi-1d").tilings, 8))
    ref_tilings = (dict(ref_get("jacobi-1d").tilings),
                   ref_rescale(ref_get("jacobi-1d").tilings, 8))
    got = port.run_job(port.SweepJob(kernel="jacobi-1d", tilings=tilings,
                                     stages=("classify", "fifoize", "size",
                                             "plan")))
    want = ref.run_job(ref.SweepJob(kernel="jacobi-1d", tilings=ref_tilings,
                                    stages=("classify", "fifoize", "size",
                                            "plan")))
    assert ([_dumps(port.report_payload(r)) for r in got]
            == [_dumps(ref.report_payload(r)) for r in want])


def test_run_job_contains_per_config_failures(monkeypatch):
    good = dict(get("gemm").tilings)
    # `repro_torch.core.sweep` the attribute is the sweep() function (the
    # package's re-export wins); reach the module through sys.modules
    sweep_mod = sys.modules["repro_torch.core.sweep"]
    real = sweep_mod._run_stages
    calls = {"n": 0}

    def flaky(a, stages, pow2, topology):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("synthetic mid-sweep failure")
        return real(a, stages, pow2, topology)

    monkeypatch.setattr(sweep_mod, "_run_stages", flaky)
    out = port.run_job(port.SweepJob(kernel="gemm",
                                     tilings=(good, good, good)))
    assert len(out) == 3
    assert "error" not in out[0] and "error" not in out[2]
    assert out[1]["error"] == {"kernel": "gemm", "config_index": 1,
                               "type": "RuntimeError",
                               "message": "synthetic mid-sweep failure"}
    assert port.run_job(port.SweepJob(kernel="not-a-kernel",
                                      tilings=({},)))[0]["error"][
        "type"] == "KeyError"
