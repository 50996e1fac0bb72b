"""The port's fault injection and channel guards
(`repro_torch.runtime.resilience`) against the JAX package's, case for
case with ``tests/test_resilience.py``.

Each case builds the same PPN and the same fault plan in both packages
(random plans from the same seeds), runs the same body on each, holds the
port to the reference test's assertions, and compares the results
exactly: fault specs, `FaultPlan.random` plans, faulted trace arrays,
guard verdicts, `ResilienceReport` dicts, the fault matrix's rows and
`AnalysisReport` JSON.  The reference's ``"pallas"`` cases run here on
``"cuda"`` with ``device="cpu"``: kernel 3's plain version.  On that
backend the rows are also recorded beside the reference's labels, and the
plain version is held to the sequential walk on every faulted event
list.  The three cases of the reference's ``train.ft`` and checkpoint
satellites are ported with the trainer: ``tests/test_torch_train.py``
(the preemption guard, the retry backoff) and
``tests/test_torch_checkpoint.py`` (the orphan sweep and ``.tmp`` refusal).
"""
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st  # noqa: E402


def _package(root):
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    m("core.polybench")                  # populate the registry
    return SimpleNamespace(
        root=root, core=m("core"), analysis=m("core.analysis"),
        polybench=m("core.polybench"), ppn=m("core.ppn"),
        schedule=m("core.schedule"), lowering=m("runtime.lowering"),
        res=m("runtime.resilience"), st=m("runtime.selftimed"),
        simulator=m("runtime.simulator"), validate=m("runtime.validate"),
        cli=m("runtime.selftimed.__main__"))


REF, PORT = _package("repro"), _package("repro_torch")
#: what the port's replays run on here: kernel 3's plain version
CPU = {"device": "cpu"}


def both(body):
    """``body`` run on the reference and on the port: the two results
    must be equal; the port's is returned."""
    want, got = body(REF), body(PORT)
    assert got == want
    return got


def _planned(P, name):
    return (P.core.analyze(P.polybench.get(name)).classify().fifoize()
            .size(pow2=True).plan(topology="sequential"))


@pytest.fixture(scope="module")
def gemm():
    out = {}
    for P in (REF, PORT):
        a = _planned(P, "gemm")
        lows = P.res.channel_lowerings(a)
        caps = P.st.executable_capacities(a)
        oracle = P.res.run_guarded(a.ppn, caps, P.res.FaultPlan(), lows)
        out[P.root] = (a, lows, caps, oracle)
    assert out["repro"][1:3] == out["repro_torch"][1:3]
    assert (out["repro"][3].resilience.as_dict()
            == out["repro_torch"][3].resilience.as_dict())
    return out


def _trace(P, a, name):
    ch = next(c for c in a.ppn.channels if c.name == name)
    return P.simulator.trace_channel(a.ppn, ch, a.ctx.sizing(a.ppn))


def _arrays(tr):
    return (tr.channel, tr.num_values, tr.num_edges, tr.pops.tolist(),
            tr.r_rank.tolist(), tr.w_rank.tolist())


def _violation(e):
    return (e.channel, e.violation, e.mechanism, e.detail)


# ------------------------------------------------------------- fault plans


def test_fault_spec_round_trips():
    def body(P):
        out = []
        for spec in ("drop:a->b.x[0]@5", "stall:compute@3*8",
                     "corrupt:a->b.x[0]@2*4", "capacity:a->b.x[0]@1*0",
                     "crash:upd@0"):
            f = P.res.parse_fault(spec)
            assert f.spec() == spec
            out.append((f.kind, f.target, f.at, f.arg, f.span))
        return out
    both(body)


def test_fault_spec_errors_are_loud():
    def body(P):
        msgs = []
        for bad in ("nonsense", "bogus:ch@1", "drop:ch@x", "drop:@1"):
            with pytest.raises(P.res.FaultSpecError) as exc:
                P.res.parse_fault(bad)
            msgs.append(str(exc.value))
        with pytest.raises(P.res.FaultSpecError) as exc:
            P.res.Fault("drop", "ch", at=-1)
        return msgs + [str(exc.value)]
    both(body)


def test_plan_validates_targets_against_the_network(gemm):
    def body(P):
        a = gemm[P.root][0]
        names = [c.name for c in a.ppn.channels]
        procs = list(a.ppn.processes)
        P.res.FaultPlan.parse(["drop:" + names[0], "stall:" + procs[0]]) \
            .validate_against(names, procs)
        msgs = []
        with pytest.raises(P.res.FaultSpecError) as exc:
            P.res.FaultPlan.parse(["drop:no-such-channel"]).validate_against(
                names, procs)
        msgs.append(str(exc.value))
        with pytest.raises(P.res.FaultSpecError) as exc:
            P.res.FaultPlan.parse(["stall:" + names[0]]).validate_against(
                names, procs)
        msgs.append(str(exc.value))
        return msgs
    both(body)


def test_random_plans_are_seed_deterministic(gemm):
    def body(P):
        a = gemm[P.root][0]
        for seed in range(8):
            p1 = P.res.FaultPlan.random(a.ppn, seed=seed)
            p2 = P.res.FaultPlan.random(a.ppn, seed=seed)
            assert p1.faults == p2.faults
        specs = [P.res.FaultPlan.random(a.ppn, seed=s).faults[0].spec()
                 for s in range(16)]
        assert len(set(specs)) > 1
        return specs
    both(body)


# ----------------------------------------------------- trace-level guards


def test_faulted_trace_keeps_arrays_coherent(gemm):
    def body(P):
        a = gemm[P.root][0]
        tr = _trace(P, a, "init->upd.C[0]")
        out = []
        for kind in ("drop", "duplicate", "reorder", "corrupt"):
            bad = P.res.faulted_trace(tr, P.res.Fault(kind, tr.channel, at=1))
            assert len(bad.pops) == len(bad.r_rank) == len(bad.w_rank)
            assert bad.num_values == tr.num_values
            out.append(_arrays(bad))
        with pytest.raises(P.res.FaultSpecError):
            P.res.faulted_trace(tr, P.res.Fault("capacity", tr.channel, at=1))
        return out
    both(body)


def test_multiset_audit_names_the_violation(gemm):
    def body(P):
        a = gemm[P.root][0]
        tr = _trace(P, a, "init->upd.C[0]")
        exp = P.res.expected_pop_counts(tr)
        assert P.res.audit_trace(tr, exp) is None
        bad = P.res.audit_trace(
            P.res.faulted_trace(tr, P.res.Fault("drop", tr.channel, 1)), exp)
        assert bad.violation == "gap" and bad.channel == tr.channel
        dup = P.res.audit_trace(
            P.res.faulted_trace(tr, P.res.Fault("duplicate", tr.channel, 1)),
            exp)
        assert dup.violation == "duplicate"
        return exp.tolist(), _violation(bad), _violation(dup)
    both(body)


def test_guarded_replay_rejects_wire_faults_on_reference(gemm):
    def body(P):
        a, lows = gemm[P.root][:2]
        fifo = P.lowering.FIFO_STREAM
        tr = _trace(P, a, "init->upd.C[0]")
        exp = P.res.expected_pop_counts(tr)
        assert lows["init->upd.C[0]"] == fifo
        out = [P.res.guarded_replay(tr, fifo, expected=exp)]
        for kind in ("drop", "duplicate", "reorder", "corrupt"):
            with pytest.raises(P.res.GuardViolation) as exc:
                P.res.guarded_replay(
                    P.res.faulted_trace(tr, P.res.Fault(kind, tr.channel, 1)),
                    fifo, expected=exp)
            assert exc.value.channel == tr.channel
            out.append(_violation(exc.value))
        return out
    both(body)


#: the labels the reference's ``guarded_replay`` gives the FIFO wire
#: faults on gemm's ``init->upd.C[0]``, and the port's ring on "cuda":
#: kind -> (violation, mechanism) on reference and on cuda
GEMM_FIFO_LABELS = {
    "drop": (("gap", "reference:ppermute"), ("gap", "multiset-audit")),
    "duplicate": (("duplicate", "reference:ppermute"),
                  ("out-of-order", "cuda:ppermute")),
    "reorder": (("out-of-order", "reference:ppermute"),
                ("out-of-order", "cuda:ppermute")),
}


@pytest.mark.parametrize("backend_name", ("selftimed", "cuda"))
def test_guarded_replay_rejects_wire_faults_on_other_backends(gemm,
                                                              backend_name):
    """The guards sit above the backend registry: the per-event queue
    machines and the port's ring (kernel 3's plain version here) reject
    the same faulted traces, naming the same culprit.  The reference's
    second backend is its pallas ring, the port's the cuda ring."""
    kw = CPU if backend_name == "cuda" else {}

    def body(P, name, kw):
        a = gemm[P.root][0]
        fifo = P.lowering.FIFO_STREAM
        tr = _trace(P, a, "init->upd.C[0]")
        exp = P.res.expected_pop_counts(tr)
        out = [P.res.guarded_replay(tr, fifo, name, expected=exp, **kw)]
        for kind in ("drop", "duplicate", "reorder"):
            with pytest.raises(P.res.GuardViolation) as exc:
                P.res.guarded_replay(
                    P.res.faulted_trace(tr, P.res.Fault(kind, tr.channel, 1)),
                    fifo, name, expected=exp, **kw)
            assert exc.value.channel == tr.channel
            out.append((kind, exc.value.channel, exc.value.violation,
                        exc.value.mechanism))
        return out

    got = body(PORT, backend_name, kw)
    if backend_name == "selftimed":
        assert got == body(REF, "selftimed", {})
        return
    ref = body(REF, "reference", {})
    assert got[0] == ref[0]                        # the clean peak
    for (kind, *r), (_, *c) in zip(ref[1:], got[1:]):
        want_ref, want_cuda = GEMM_FIFO_LABELS[kind]
        assert tuple(r) == ("init->upd.C[0]",) + want_ref
        assert tuple(c) == ("init->upd.C[0]",) + want_cuda


#: gemm's trace matrix on the port's "cuda" rows: (fault, violation,
#: mechanism), beside the reference rows' violations
GEMM_CUDA_ROWS = [
    ("drop:init->upd.C[0]@1", "gap", "multiset-audit"),
    ("duplicate:init->upd.C[0]@1", "out-of-order", "cuda:ppermute"),
    ("reorder:init->upd.C[0]@1", "out-of-order", "cuda:ppermute"),
    ("corrupt:init->upd.C[0]@1*3", "out-of-order", "cuda:ppermute"),
    ("drop:load_C->init.C[0]@1", "gap", "multiset-audit"),
    ("duplicate:load_C->init.C[0]@1", "duplicate", "multiset-audit"),
    ("corrupt:load_C->init.C[0]@1*3", "gap", "multiset-audit"),
]
GEMM_REF_VIOLATIONS = ["gap", "duplicate", "out-of-order", "out-of-order",
                       "gap", "duplicate", "gap"]


def test_faults_validate_trace_matrix_on_cuda(gemm):
    a = gemm["repro_torch"][0]
    v = PORT.res.faults_validate(a, trace_backends=("reference", "cuda"),
                                 device="cpu")
    backends = {r["backend"] for r in v.trace_matrix}
    assert backends == {"reference", "cuda"}
    assert all(r["detected"] for r in v.trace_matrix)
    want = REF.res.faults_validate(gemm["repro"][0])
    ref_rows = [r for r in v.trace_matrix if r["backend"] == "reference"]
    assert ref_rows == want.trace_matrix
    assert v.matrix == want.matrix and v.clean == want.clean
    cuda_rows = [r for r in v.trace_matrix if r["backend"] == "cuda"]
    assert [r["fault"] for r in cuda_rows] == [r["fault"] for r in ref_rows]
    assert [(r["fault"], r["violation"], r["mechanism"])
            for r in cuda_rows] == GEMM_CUDA_ROWS
    assert [r["violation"] for r in ref_rows] == GEMM_REF_VIOLATIONS


def test_reorder_is_legal_on_an_addressable_buffer_but_drop_is_not(gemm):
    def body(P):
        a = gemm[P.root][0]
        rb = P.lowering.REORDER_BUFFER
        tr = _trace(P, a, "load_C->init.C[0]")
        exp = P.res.expected_pop_counts(tr)
        peak = P.res.guarded_replay(
            P.res.faulted_trace(tr, P.res.Fault("reorder", tr.channel, 1)),
            rb, expected=exp)
        with pytest.raises(P.res.GuardViolation) as exc:
            P.res.guarded_replay(
                P.res.faulted_trace(tr, P.res.Fault("drop", tr.channel, 1)),
                rb, expected=exp)
        assert exc.value.violation == "gap"
        assert exc.value.mechanism == "multiset-audit"
        return peak, _violation(exc.value)
    both(body)


# ------------------------------------- kernel 3's scan on faulted traces


@pytest.mark.parametrize("name", ["gemm", "jacobi-1d"])
def test_replay_scan_equals_walk_on_faulted_traces(name):
    """Every faulted trace of the kernel's matrix, lowered to the event
    list the "cuda" ring replays, gives the same six counters through the
    tiled scan (tiles of 4096 and 61 events) as through the sequential
    walk, in the discipline of the channel's lowering."""
    from repro_torch.runtime import cuda_backend as cb

    a = (PORT.core.analyze(PORT.polybench.get(name)).classify().fifoize()
         .size(pow2=True))
    cases = PORT.res.wire_faults(a)
    assert len(cases) == (10 if name == "jacobi-1d" else 7)
    for case in cases:
        assert case.trace.num_edges
        ev = cb.ring_events(case.trace)
        op = PORT.lowering.backend("cuda").implementation(
            case.lowering).order_op
        ts = [torch.from_numpy(x) for x in (ev.kind, ev.value, ev.slot)]
        want = cb._replay_walk(*ts, ev.ring, op).tolist()
        for tile in (cb.REPLAY_TILE, 61):
            got = cb._replay_plain(*ts, ev.ring, op, tile=tile).tolist()
            assert got == want, (case.fault.spec(), tile)
        assert cb.replay_events(*ts, ev.ring, op).tolist() == want


def test_wire_faults_are_the_trace_matrix_cases(gemm):
    a = gemm["repro_torch"][0]
    cases = PORT.res.wire_faults(a)
    want = REF.res.faults_validate(gemm["repro"][0]).trace_matrix
    assert [(c.mode, c.fault.spec()) for c in cases] == [
        (r["mode"], r["fault"]) for r in want]
    ref_a = gemm["repro"][0]
    for c in cases:
        tr = _trace(REF, ref_a, c.fault.target)
        ref_fault = REF.res.parse_fault(c.fault.spec())
        assert _arrays(c.trace) == _arrays(REF.res.faulted_trace(tr,
                                                                 ref_fault))
        assert c.expected.tolist() == REF.res.expected_pop_counts(tr).tolist()


def test_faults_validate_defaults_to_the_card(gemm, monkeypatch):
    """No fallback hides the card or the kernel: with no device named the
    "cuda" rows run on the card (there is none here, so the call raises),
    and a replay whose launch fails fails the matrix instead of counting
    as a detection."""
    a = gemm["repro_torch"][0]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            PORT.res.faults_validate(a)
        with pytest.raises((RuntimeError, AssertionError)):
            a.validate(mode="faults")
    from repro_torch.runtime import cuda_backend as cb

    def broken(*args, **kw):
        raise RuntimeError("replay launch failed")

    monkeypatch.setattr(cb, "replay_events", broken)
    with pytest.raises(RuntimeError, match="replay launch failed"):
        PORT.res.faults_validate(a, device="cpu")


# ------------------------------------------------------- engine-level runs


def test_clean_guarded_run_is_clean_and_cheap_on_events(gemm):
    def body(P):
        a, lows, caps, oracle = gemm[P.root]
        r = oracle.resilience
        assert r.status == "clean" and r.completed
        assert not r.detections and not r.recoveries
        assert r.guard_events > 0
        return r.as_dict(), oracle.run.as_dict()
    both(body)


@pytest.mark.parametrize("spec,mechanism", [
    ("drop:init->upd.C[0]@1", "progress-watchdog"),
    ("duplicate:init->upd.C[0]@1", "sequence-tag"),
    ("reorder:init->upd.C[0]@1", "sequence-tag"),
    ("corrupt:init->upd.C[0]@1*3", "checksum"),
    ("capacity:init->upd.C[0]@1*0", "progress-watchdog"),
    ("stall:upd@2*3", "progress-watchdog"),
    ("crash:upd@2", "progress-watchdog"),
])
def test_every_fault_kind_is_detected_and_healed(gemm, spec, mechanism):
    def body(P):
        a, lows, caps, oracle = gemm[P.root]
        plan = P.res.FaultPlan.parse([spec], snapshot_window=64)
        gr = P.res.run_guarded(a.ppn, caps, plan, lows, oracle=oracle)
        r = gr.resilience
        assert r.injected, spec
        assert r.status in ("recovered", "degraded"), (spec, r.summary())
        assert mechanism in {d["mechanism"] for d in r.detections}
        assert r.completed
        assert r.outputs_match is True
        assert not r.undetected
        return r.as_dict(), gr.run.as_dict()
    both(body)


def test_hot_swap_degrades_fifo_to_reorder_buffer_end_to_end(gemm):
    def body(P):
        a, lows, caps, oracle = gemm[P.root]
        gr = P.res.run_guarded(
            a.ppn, caps,
            P.res.FaultPlan.single("reorder", "init->upd.C[0]", at=1),
            lows, oracle=oracle)
        r = gr.resilience
        assert r.status == "degraded" and r.outputs_match is True
        (swap,) = r.swaps
        assert swap["channel"] == "init->upd.C[0]"
        assert swap["from"] == P.lowering.FIFO_STREAM
        assert (swap["to"] == P.lowering.degrade(P.lowering.FIFO_STREAM)
                == P.lowering.REORDER_BUFFER)
        assert swap["stream_slots"] == caps["init->upd.C[0]"]
        assert swap["addressable_slots"] >= 1
        return r.as_dict()
    both(body)


def test_degradation_table_covers_every_stream_lowering():
    def body(P):
        for low, to in P.lowering.DEGRADED_LOWERING.items():
            assert (P.lowering.degrade(low) == to
                    == P.lowering.REORDER_BUFFER)
        with pytest.raises(KeyError):
            P.lowering.degrade(P.lowering.REORDER_BUFFER)
        return dict(P.lowering.DEGRADED_LOWERING)
    both(body)


def test_capacity_loss_spills_to_unbounded_with_accounting(gemm):
    def body(P):
        a, lows, caps, oracle = gemm[P.root]
        gr = P.res.run_guarded(
            a.ppn, caps,
            P.res.FaultPlan.single("capacity", "init->upd.C[0]", at=1,
                                   arg=0),
            lows, oracle=oracle)
        r = gr.resilience
        assert r.completed and r.outputs_match is True
        spill = next(s for s in r.spills if s["channel"] == "init->upd.C[0]")
        assert spill["fault_induced"] is True
        assert spill["capacity"] == 0
        assert spill["planned"] == caps["init->upd.C[0]"]
        return r.as_dict()
    both(body)


def test_undersized_snapshot_window_gives_up_loudly(gemm):
    def body(P):
        a, lows, caps, oracle = gemm[P.root]
        plan = P.res.FaultPlan(
            faults=(P.res.Fault("drop", "load_C->init.C[0]", at=1),),
            snapshot_window=1)
        gr = P.res.run_guarded(a.ppn, caps, plan, lows, oracle=oracle)
        r = gr.resilience
        assert r.status == "unrecovered"
        assert any(e["target"] == "load_C->init.C[0]" for e in r.unrecovered)
        assert {d["target"] for d in r.detections} >= {"load_C->init.C[0]"}
        assert r.outputs_match is False
        return r.as_dict()
    both(body)


def test_watchdog_budget_is_a_hard_bound():
    def body(P):
        wd = P.res.ProgressWatchdog(limit=3, max_restarts=1)
        assert [wd.tick() for _ in range(4)] == [True, True, True, False]
        assert wd.exhausted
        assert wd.restart() is True and wd.restart() is False
        return wd.as_dict()
    both(body)


def test_detect_only_mode_reports_without_healing(gemm):
    def body(P):
        a, lows, caps, oracle = gemm[P.root]
        gr = P.res.run_guarded(
            a.ppn, caps,
            P.res.FaultPlan.single("corrupt", "init->upd.C[0]", at=1),
            lows, recover=False, oracle=oracle)
        r = gr.resilience
        assert any(d["mechanism"] == "checksum" for d in r.detections)
        assert not r.recoveries
        assert r.outputs_match is False
        return r.as_dict()
    both(body)


# ------------------------------------------- deterministic random property


def _chain_ppn(P, n_procs, n, reverse_last):
    """A 2–3-process chain: src -> mid [-> sink], identity dataflow, with
    the last hop optionally reversed (an out-of-order channel)."""
    pts = np.arange(n, dtype=np.int64)[:, None]
    sched = P.schedule.AffineSchedule(("i",), [P.core.v("i")])
    names = ["src", "mid", "sink"][:n_procs]
    procs = {nm: P.ppn.Process(nm, ("i",), sched, pts, stmt_rank=k)
             for k, nm in enumerate(names)}
    chans = []
    for a, b in zip(names, names[1:]):
        dst = pts[::-1].copy() if (reverse_last and b == names[-1]) else pts
        chans.append(P.ppn.Channel(a, b, 0, "x", pts, dst))
    return P.ppn.PPN(f"chain{n_procs}", {"N": n}, procs, chans)


def _check_guarded(P, ppn, plan):
    """The property: detect-or-recover, oracle-equal outputs on recovery,
    named culprit otherwise — and the run always terminates."""
    a = P.core.analyze(ppn).classify().size(pow2=True)
    lows = P.res.channel_lowerings(a)
    caps = P.st.executable_capacities(a)
    oracle = P.res.run_guarded(ppn, caps, P.res.FaultPlan(), lows)
    assert oracle.status == "clean" and oracle.run.completed
    gr = P.res.run_guarded(ppn, caps, plan, lows, oracle=oracle)
    r = gr.resilience
    if not r.injected:
        assert r.status == "clean"
        return r.as_dict()
    assert not r.undetected, plan.faults[0].spec()
    if r.status == "clean":
        assert r.completed and r.outputs_match is True
    elif r.status in ("recovered", "degraded"):
        assert r.completed
        assert r.outputs_match is True, plan.faults[0].spec()
    else:
        assert r.status == "unrecovered"
        named = {e["target"] for e in r.unrecovered} | \
                {d["target"] for d in r.detections}
        assert plan.faults[0].target in named
    return r.as_dict()


@pytest.mark.parametrize("seed", range(40))
def test_random_single_faults_detect_or_recover(seed):
    def body(P):
        rng = np.random.RandomState(seed)
        ppn = _chain_ppn(P, n_procs=int(rng.randint(2, 4)),
                         n=int(rng.randint(3, 13)),
                         reverse_last=bool(rng.randint(2)))
        plan = P.res.FaultPlan.random(ppn, seed=seed)
        return plan.faults[0].spec(), _check_guarded(P, ppn, plan)
    both(body)


@settings(max_examples=60, deadline=None)
@given(n_procs=st.integers(2, 3), n=st.integers(3, 12),
       reverse_last=st.booleans(), seed=st.integers(0, 10_000))
def test_hypothesis_random_faults_detect_or_recover(n_procs, n,
                                                    reverse_last, seed):
    def body(P):
        ppn = _chain_ppn(P, n_procs, n, reverse_last)
        plan = P.res.FaultPlan.random(ppn, seed=seed)
        return plan.faults[0].spec(), _check_guarded(P, ppn, plan)
    both(body)


# ------------------------------------------------- validate stage + schema


def test_validate_mode_faults_produces_green_matrix(gemm):
    a = _planned(PORT, "gemm").validate(mode="faults", device="cpu")
    assert a.resilience is not None
    assert a.resilience.matrix and a.resilience.trace_matrix
    assert all(row["detected"] for row in a.resilience.matrix)
    assert all(row["detected"] for row in a.resilience.trace_matrix)
    assert a.resilience.trace_backends == ["reference", "cuda"]
    assert a.ctx.counters["faults_stages"] == 1
    assert a.stages[-1] == "faults"
    want = _planned(REF, "gemm").validate(mode="faults").resilience
    assert a.resilience.matrix == want.matrix
    assert [r for r in a.resilience.trace_matrix
            if r["backend"] == "reference"] == want.trace_matrix
    # on the reference backend alone the evidence is the reference's
    ref_only = _planned(PORT, "gemm").validate(mode="faults",
                                               backend="reference")
    assert ref_only.resilience.as_dict() == want.as_dict()


def test_resilience_evidence_round_trips_through_report(gemm):
    def body(P):
        a = _planned(P, "gemm").validate(mode="faults", backend="reference")
        rep = a.report()
        doc = rep.as_dict()
        assert doc["schema_version"] == P.analysis.SCHEMA_VERSION == 5
        assert doc["resilience"]["mode"] == "faults"
        assert doc["resilience"]["counts"]["engine_cases"] > 0
        back = P.analysis.AnalysisReport.from_dict(json.loads(rep.to_json()))
        assert back.resilience == doc["resilience"]
        doc.pop("cache")
        return doc
    doc = both(body)
    # the evidence crosses between the packages both ways, the port's
    # with its "cuda" rows
    port_text = (_planned(PORT, "gemm").validate(mode="faults", device="cpu")
                 .report().to_json())
    ref_text = (_planned(REF, "gemm").validate(mode="faults").report()
                .to_json())
    for text, dst in ((ref_text, PORT), (port_text, REF)):
        assert dst.analysis.AnalysisReport.from_json(text).to_json() == text
    back = PORT.analysis.AnalysisReport.from_json(ref_text)
    assert back.resilience == doc["resilience"]
    counts = json.loads(port_text)["resilience"]["counts"]
    assert counts["trace_cases"] == 2 * doc["resilience"]["counts"][
        "trace_cases"]


def test_unknown_validate_mode_still_fails_loudly():
    def body(P):
        with pytest.raises(ValueError, match="faults") as exc:
            _planned(P, "gemm").validate(mode="nonsense")
        return str(exc.value)
    both(body)


# ----------------------------------------------------------- CLI contract


def test_cli_inject_exit_codes(capsys):
    def body(P):
        main = P.cli.main
        out = []
        assert main(["--kernel", "gemm", "--policy", "sequential",
                     "--inject", "duplicate:init->upd.C[0]@1"]) == 0
        cap = capsys.readouterr()
        assert "recovered" in cap.out
        out.append((cap.out, cap.err))
        assert main(["--kernel", "gemm", "--policy", "sequential",
                     "--inject", "reorder:init->upd.C[0]@1"]) == 0
        cap = capsys.readouterr()
        assert "degraded" in cap.out and "notice" in cap.err
        out.append((cap.out, cap.err))
        assert main(["--kernel", "gemm", "--inject", "bogus:x@1"]) == 2
        cap = capsys.readouterr()
        out.append((cap.out, cap.err))
        return out
    both(body)
