"""The port's self-timed engine (`repro_torch.runtime.selftimed`) against
the JAX package's, case for case with ``tests/test_selftimed.py`` and its
hypothesis property file.

Each case builds the same PPN in both packages (random shapes from numpy
or hypothesis, no torch randomness), runs the same body on each, holds
the port to the same assertions as the reference's test, and compares
what both give exactly: every result is integer or structural — reports
(``as_dict()``: steps, fires, per-channel high-water marks and stalls,
the deadlock's culprit, cycle and step), validation evidence and
`AnalysisReport` JSON.  The engine runs on the host in both packages, so
nothing here needs a card.
"""
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st  # noqa: E402

FEEDBACK = "decode->decode.state[0]"


def _package(root):
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    m("core.polybench")                  # populate the registry
    return SimpleNamespace(
        root=root, core=m("core"), analysis=m("core.analysis"),
        polybench=m("core.polybench"), ppn=m("core.ppn"),
        schedule=m("core.schedule"), planner=m("comm.planner"),
        lowering=m("runtime.lowering"), st=m("runtime.selftimed"),
        batching=m("serve.batching"))


REF, PORT = _package("repro"), _package("repro_torch")


def both(body):
    """``body`` run on the reference and on the port: the two results
    must be equal; the port's is returned."""
    want, got = body(REF), body(PORT)
    assert got == want
    return got


def _sized(P, name, fifoize=True):
    a = P.core.analyze(P.polybench.get(name)).classify()
    if fifoize:
        a = a.fifoize()
    return a.size(pow2=True)


# ------------------------------------------------------------ firing rule


@pytest.mark.parametrize("policy", ["sequential", "concurrent"])
def test_acyclic_kernel_completes_at_planned_capacities(policy):
    def body(P):
        a = _sized(P, "jacobi-1d")
        rep = P.st.execute_ppn(a.ppn, P.st.executable_capacities(a),
                               policy=policy)
        assert rep.completed and rep.deadlock is None
        assert rep.fires == rep.total_instances
        for c in rep.channels:
            if c.capacity is not None:
                assert c.high_water <= c.capacity, c.name
        return rep.as_dict()
    both(body)


def test_sequential_policy_fires_one_instance_per_step():
    def body(P):
        a = _sized(P, "gemm")
        rep = P.st.execute_ppn(a.ppn, P.st.executable_capacities(a),
                               policy="sequential")
        assert rep.completed
        assert rep.steps == rep.fires == rep.total_instances
        assert rep.throughput == 1.0
        return rep.as_dict()
    both(body)


def test_concurrent_policy_overlaps_fires():
    def body(P):
        a = _sized(P, "jacobi-1d")
        rep = P.st.execute_ppn(a.ppn, P.st.executable_capacities(a),
                               policy="concurrent")
        assert rep.completed
        assert rep.steps < rep.total_instances
        assert rep.throughput > 1.0
        return rep.as_dict()
    both(body)


def test_sequential_replay_matches_trace_simulator_exactly():
    def body(P):
        val = P.st.selftimed_validate(_sized(P, "gemm"))
        assert val.report.completed
        assert val.report.out_of_order == []
        assert val.exempt == []
        hw = val.report.high_water()
        for name, peak in val.exact.items():
            assert hw[name] == peak, name
        assert val.exact_matches == len(val.exact)
        return val.as_dict()
    both(body)


def test_out_of_order_fires_are_exempt_not_wrong():
    def body(P):
        val = P.st.selftimed_validate(_sized(P, "symm"))
        assert val.report.completed
        assert val.report.out_of_order
        assert val.exempt
        deviant = set(val.report.out_of_order)
        for name in val.exempt:
            pro, rest = name.split("->", 1)
            con = rest.split(".", 1)[0]
            assert (val.late.get(name, 0) > 0
                    or pro in deviant or con in deviant), name
        return val.as_dict()
    both(body)


def test_late_channels_run_unbounded_and_demand_is_measured():
    def body(P):
        a = _sized(P, "atax")
        caps = P.st.executable_capacities(a)
        assert caps["tupd->yupd.tmp[1]"] is None
        planned = P.st.planned_capacities(a)
        assert planned["tupd->yupd.tmp[1]"] >= 1
        val = P.st.selftimed_validate(a)
        assert val.measured["tupd->yupd.tmp[1]"] == 4
        return caps, planned, val.as_dict()
    both(body)


def test_planned_capacities_floor_fully_late_channels_at_one():
    def body(P):
        caps = P.st.planned_capacities(_sized(P, "gesummv"))
        assert all(s >= 1 for s in caps.values())
        return caps
    both(body)


# ------------------------------------------------------ deadlock detection


def _caps_with_feedback(P, ppn, fb_slots):
    a = P.core.analyze(ppn).classify().size(pow2=True)
    caps = P.st.executable_capacities(a)
    caps[FEEDBACK] = fb_slots
    return caps


def test_decode_loop_completes_at_exact_feedback_capacity():
    def body(P):
        ppn = P.batching.decode_loop_ppn(slots=4, steps=8)
        assert P.st.process_cycles(ppn) == [["decode"]]
        assert FEEDBACK in P.st.cycle_channels(ppn)
        rep = P.st.execute_ppn(ppn, _caps_with_feedback(P, ppn, 4),
                               policy="concurrent")
        assert rep.completed
        assert rep.channel(FEEDBACK).high_water == 4
        return rep.as_dict()
    both(body)


def test_decode_loop_self_deadlocks_below_batch_width():
    def body(P):
        ppn = P.batching.decode_loop_ppn(slots=4, steps=8)
        with pytest.raises(P.st.DeadlockError) as exc:
            P.st.execute_ppn(ppn, _caps_with_feedback(P, ppn, 3),
                             policy="concurrent")
        rep = exc.value.report
        dl = rep.deadlock
        assert dl is not None
        assert dl.culprit == FEEDBACK
        assert FEEDBACK in dl.cycle_channels()
        assert any(e["process"] == "decode" and e["kind"] == "full"
                   for e in dl.cycle)
        assert rep.fires + dl.pending == rep.total_instances
        return rep.as_dict(), str(exc.value)
    both(body)


def test_on_deadlock_report_returns_instead_of_raising():
    def body(P):
        ppn = P.batching.decode_loop_ppn(slots=2, steps=4)
        rep = P.st.execute_ppn(ppn, _caps_with_feedback(P, ppn, 1),
                               policy="sequential", on_deadlock="report")
        assert not rep.completed
        assert rep.deadlock is not None
        assert rep.deadlock.culprit == FEEDBACK
        return rep.as_dict()
    both(body)


def test_zero_capacity_channel_deadlocks_immediately():
    def body(P):
        ppn = P.batching.decode_loop_ppn(slots=2, steps=3)
        a = P.core.analyze(ppn).classify().size(pow2=True)
        caps = P.st.executable_capacities(a)
        caps["prefill->decode.state[0]"] = 0
        rep = P.st.execute_ppn(ppn, caps, policy="concurrent",
                               on_deadlock="report")
        assert not rep.completed and rep.deadlock.fires == 0
        return rep.as_dict()
    both(body)


def test_deadlock_detection_is_structural_not_a_timeout():
    def body(P):
        ppn = P.batching.decode_loop_ppn(slots=4, steps=8)
        rep = P.st.execute_ppn(ppn, _caps_with_feedback(P, ppn, 2),
                               policy="concurrent", on_deadlock="report")
        dl = rep.deadlock
        assert dl.step <= rep.steps
        names = {c.name for c in rep.channels}
        for e in dl.blocked:
            assert e["channel"] in names
            if e["kind"] == "full":
                assert e["occupancy"] == e["capacity"]
        return rep.as_dict()
    both(body)


def test_process_cycles_on_acyclic_network():
    def body(P):
        cycles = P.st.process_cycles(_sized(P, "gemver").ppn)
        assert all("upd" in cyc[0] for cyc in cycles)
        return cycles
    both(body)


# ------------------------------------------------------------ pipeline ring


def _ring(P, schedule, stages=4, microbatches=6, chunks=2):
    return P.planner.PipelineSpec(stages=stages, microbatches=microbatches,
                                  chunks=chunks, schedule=schedule)


@pytest.mark.parametrize("schedule", ["gpipe", "vpp-blocked"])
def test_ring_completes_at_tick_capacities(schedule):
    def body(P):
        rep = P.planner.ring_selftimed(_ring(P, schedule))
        assert rep.completed
        assert rep.fires == rep.total_instances
        return rep.as_dict()
    both(body)


def test_vpp_ring_wraparound_is_cyclic_and_bounded():
    def body(P):
        ppn, caps = P.planner.ring_executable(_ring(P, "vpp-blocked"))
        assert P.st.process_cycles(ppn)
        wrap = "stage3->stage0.act[0]"
        assert caps[wrap] == 1
        rep = P.st.execute_ppn(ppn, caps, policy="concurrent")
        assert rep.completed
        assert rep.channel(wrap).high_water <= 1
        return caps, rep.as_dict()
    both(body)


def test_vpp_ring_shrunk_wraparound_deadlocks_naming_it():
    def body(P):
        wrap = "stage3->stage0.act[0]"
        rep = P.planner.ring_selftimed(_ring(P, "vpp-blocked"),
                                       shrink={wrap: 0},
                                       on_deadlock="report")
        assert not rep.completed
        assert wrap in {e["channel"] for e in rep.deadlock.blocked}
        return rep.as_dict()
    both(body)


def test_mixed_ring_exposes_tick_capacity_shortfall():
    def body(P):
        spec = _ring(P, "mixed")
        culprit = "stage2->stage3.act[0]@2"
        rep = P.planner.ring_selftimed(spec, on_deadlock="report")
        assert not rep.completed
        assert rep.deadlock.culprit == culprit
        _, caps = P.planner.ring_executable(spec)
        relaxed = P.planner.ring_selftimed(
            spec, shrink={culprit: caps[culprit] + 1})
        assert relaxed.completed
        return rep.as_dict(), relaxed.as_dict()
    both(body)


def test_ring_shrink_rejects_unknown_channels():
    def body(P):
        spec = _ring(P, "gpipe", stages=2, microbatches=2, chunks=1)
        with pytest.raises(KeyError) as exc:
            P.planner.ring_selftimed(spec, shrink={"no-such-channel": 1})
        return str(exc.value)
    both(body)


# ------------------------------------------------------------ observability


def test_report_accounts_every_stall_to_a_channel():
    def body(P):
        a = _sized(P, "jacobi-1d")
        rep = P.st.execute_ppn(a.ppn, P.st.executable_capacities(a),
                               policy="concurrent")
        by_proc = sum(p.stalls for p in rep.processes)
        by_chan = sum(c.stalls for c in rep.channels)
        assert by_proc == by_chan == rep.total_stalls
        for p in rep.processes:
            assert sum(p.stall_channels.values()) == p.stalls
        assert 0.0 < rep.stall_ratio < 1.0
        return rep.as_dict(), rep.total_stalls
    both(body)


def test_timeline_records_fires_and_stalls():
    def body(P):
        ppn = P.batching.decode_loop_ppn(slots=3, steps=4)
        rep = P.st.execute_ppn(ppn, _caps_with_feedback(P, ppn, 3),
                               policy="concurrent", record_timeline=True)
        assert set(rep.timeline) == {"prefill", "decode"}
        assert rep.timeline["decode"].count("F") == 12
        assert set(rep.timeline["decode"]) <= {"F", "i", "o", "."}
        return dict(rep.timeline), rep.as_dict()
    both(body)


def test_critical_cycle_names_the_stalling_scc():
    def body(P):
        rep = P.planner.ring_selftimed(_ring(P, "vpp-blocked"))
        cc = rep.critical_cycle
        assert cc is not None
        assert set(cc["processes"]) == {f"stage{i}" for i in range(4)}
        assert cc["stalls"] > 0
        return cc
    both(body)


def test_render_and_summary_are_self_contained():
    def body(P):
        ppn = P.batching.decode_loop_ppn(slots=4, steps=8)
        rep = P.st.execute_ppn(ppn, _caps_with_feedback(P, ppn, 3),
                               policy="concurrent", record_timeline=True,
                               on_deadlock="report")
        text = rep.render()
        assert "DEADLOCK" in rep.summary()
        for needle in (FEEDBACK, "culprit", "timeline"):
            assert needle in text, needle
        doc = rep.as_dict()
        assert json.loads(json.dumps(doc)) == doc
        return text, rep.summary(), doc
    both(body)


# ------------------------------------------------- Analysis / report wiring


def test_validate_mode_selftimed_attaches_evidence():
    def body(P):
        a = _sized(P, "jacobi-1d").validate(mode="selftimed")
        assert a.selftimed is not None
        assert a.selftimed.report.completed
        assert a.selftimed.negative
        for n in a.selftimed.negative:
            assert n["observed"] in ("deadlock", "slowdown")
        assert a.ctx.counters["selftimed_stages"] == 1
        return a.selftimed.as_dict(), a.stages
    both(body)


def test_selftimed_evidence_round_trips_through_analysis_report():
    def body(P):
        a = (_sized(P, "gemm").plan(topology="sequential")
             .validate(mode="selftimed"))
        rep = a.report()
        doc = rep.as_dict()
        assert doc["schema_version"] == P.analysis.SCHEMA_VERSION == 5
        assert doc["selftimed"]["mode"] == "selftimed"
        assert doc["selftimed"]["completed"] is True
        back = P.analysis.AnalysisReport.from_dict(json.loads(rep.to_json()))
        assert back.selftimed == doc["selftimed"]
        doc.pop("cache")
        return doc
    doc = both(body)
    # the evidence crosses between the packages both ways
    for src, dst in ((REF, PORT), (PORT, REF)):
        text = (_sized(src, "gemm").plan(topology="sequential")
                .validate(mode="selftimed").report().to_json())
        back = dst.analysis.AnalysisReport.from_json(text)
        assert back.to_json() == text
        assert back.selftimed == doc["selftimed"]


def test_negative_direction_on_cyclic_decode_loop():
    def body(P):
        a = (P.core.analyze(P.batching.decode_loop_ppn(slots=4, steps=6))
             .classify().size(pow2=True).validate(mode="selftimed"))
        outcomes = {n["channel"]: n for n in a.selftimed.negative}
        fb = outcomes[FEEDBACK]
        assert fb["observed"] == "deadlock"
        assert fb["culprit"] == FEEDBACK
        return a.selftimed.as_dict()
    both(body)


# ------------------------------------------------------- backend registry


def test_selftimed_backend_is_registered_lazily():
    def body(P):
        status = P.lowering.available_backends()
        assert "selftimed" in status
        assert status["selftimed"].startswith("ok")
        assert P.lowering.backend("selftimed").compile is not None
        return status["selftimed"], sorted(P.lowering.backend("selftimed"))
    both(body)


def test_backend_validate_parity_with_reference():
    def body(P):
        ref = (_sized(P, "jacobi-1d").plan(topology="sequential")
               .validate(backend="reference").validation)
        st_ = (_sized(P, "jacobi-1d").plan(topology="sequential")
               .validate(backend="selftimed").validation)
        assert [c.peak for c in st_.channels] == [c.peak
                                                   for c in ref.channels]
        assert [c.late for c in st_.channels] == [c.late
                                                   for c in ref.channels]
        return [(c.name, c.peak, c.late) for c in st_.channels]
    both(body)


def test_broken_backend_import_raises_backend_unavailable(monkeypatch):
    for P in (REF, PORT):
        lowering = P.lowering
        monkeypatch.setitem(lowering._LAZY_BACKENDS, "selftimed",
                            f"{P.root}.runtime.selftimed_does_not_exist")
        monkeypatch.delitem(lowering._REGISTRY, "selftimed", raising=False)
        with pytest.raises(lowering.BackendUnavailable):
            lowering.backend("selftimed")


def test_selftimed_backend_refuses_a_device():
    """The port's compile hands ``device=`` to every backend's hook: the
    host-only backend refuses a device rather than run on the host in its
    place, and so do its queue machines under ``validate``."""
    a = _sized(PORT, "jacobi-1d").plan(topology="sequential")
    for device in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="host"):
            a.compile(backend="selftimed", device=device)
        with pytest.raises(ValueError, match="host"):
            a.validate(backend="selftimed", device=device)
    machine = a.compile(backend="selftimed")
    want = (_sized(REF, "jacobi-1d").plan(topology="sequential")
            .compile(backend="selftimed").run())
    assert machine.run().as_dict() == want.as_dict()


# ------------------------------------------- late_parts (split validation)


def test_split_plan_validation_reports_late_edges_per_part():
    def body(P):
        a = (P.core.analyze(P.polybench.get("jacobi-1d")).classify()
             .size(pow2=True).plan(topology="sequential"))
        split_plans = {p.name: p for p in a.plans if p.split}
        assert split_plans
        rep = a.validate(backend="reference").validation
        for cv in rep.channels:
            assert cv.late == sum(cv.late_parts.values())
            if cv.name in split_plans:
                assert len(cv.late_parts) == len(split_plans[cv.name].parts)
                for part in cv.late_parts:
                    assert part.startswith(cv.name + "@")
        return [(cv.name, cv.late, dict(cv.late_parts))
                for cv in rep.channels]
    both(body)


# -------------------------------------- deterministic capacity boundary


def _cyclic_loop(P, slots, steps, tail=False):
    """decode_loop_ppn generalized with an optional third (sink) process."""
    ppn = P.batching.decode_loop_ppn(slots, steps)
    if not tail:
        return ppn
    ss, tt = np.meshgrid(np.arange(slots), np.arange(steps), indexing="ij")
    pts = np.stack([ss.ravel(), tt.ravel()], axis=1)
    sched = P.schedule.AffineSchedule(("s", "t"),
                                      [P.core.v("t") * slots + P.core.v("s")])
    procs = dict(ppn.processes)
    procs["emit"] = P.ppn.Process("emit", ("s", "t"), sched, pts,
                                  stmt_rank=2)
    chans = list(ppn.channels) + [P.ppn.Channel("decode", "emit", 0, "tok",
                                                pts, pts)]
    return P.ppn.PPN(ppn.kernel_name, ppn.params, procs, chans)


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("policy", ["sequential", "concurrent"])
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_completion_boundary_is_exactly_the_frontier(slots, policy, tail):
    def body(P):
        ppn = _cyclic_loop(P, slots, steps=4, tail=tail)
        cyc = set(P.st.cycle_channels(ppn))
        docs = []
        for cap in range(0, slots + 2):
            caps = {ch.name: None for ch in ppn.channels}
            caps[FEEDBACK] = cap
            rep = P.st.execute_ppn(ppn, caps, policy=policy,
                                   on_deadlock="report")
            assert rep.completed == (cap >= slots), (slots, cap, policy)
            if not rep.completed:
                assert set(rep.deadlock.cycle_channels()) & cyc
            else:
                assert rep.channel(FEEDBACK).high_water == slots
            docs.append(rep.as_dict())
        return docs
    both(body)


# ----------------------------------------------------------- full sweep


@pytest.mark.parametrize("name", ["trmm", "syrk", "syr2k", "gemver",
                                  "gesummv", "lu", "cholesky", "doitgen",
                                  "jacobi-2d", "seidel-2d", "heat-3d"])
def test_every_kernel_validates_selftimed(name):
    def body(P):
        val = P.st.selftimed_validate(_sized(P, name))
        assert val.report.completed
        hw = val.report.high_water()
        for cname, peak in val.exact.items():
            if cname not in val.exempt:
                assert hw[cname] == peak, cname
        return val.as_dict()
    both(body)


# ------------------------------------------ property (random cyclic PPNs)


@settings(max_examples=60, deadline=None)
@given(slots=st.integers(1, 5),
       steps=st.integers(2, 6),
       extra=st.integers(-2, 3),
       tail=st.booleans(),
       policy=st.sampled_from(["sequential", "concurrent"]))
def test_completion_iff_capacity_covers_the_exact_peak(slots, steps, extra,
                                                       tail, policy):
    def body(P):
        ppn = _cyclic_loop(P, slots, steps, tail)
        cap = max(0, slots + extra)
        caps = {ch.name: None for ch in ppn.channels}
        caps[FEEDBACK] = cap
        rep = P.st.execute_ppn(ppn, caps, policy=policy,
                               on_deadlock="report")
        assert rep.completed == (cap >= slots)
        if rep.completed:
            assert rep.fires == rep.total_instances
            assert rep.channel(FEEDBACK).high_water == slots
            assert rep.deadlock is None
        else:
            dl = rep.deadlock
            assert dl is not None
            assert set(dl.cycle_channels()) & set(P.st.cycle_channels(ppn))
            assert dl.culprit == FEEDBACK
            assert rep.fires < rep.total_instances
        return rep.as_dict()
    both(body)
