"""The port's trace-replay backend (`repro_torch.runtime.cuda_backend`)
against the JAX package.

1. Registry: the ``"cuda"`` backend implements the full lowering vocabulary
   and carries the whole-PPN compile hook.
2. `_build_events` gives byte-identical event lists to the reference's on
   the `tests/test_runtime.py` verdict matrix and on every channel of the
   three stencils.
3. The verdict matrix holds on ``"cuda"`` (plain version on the CPU): the
   peak equals the reference simulator's, `OrderViolation` fires where
   `tests/test_pallas.py` expects it, undersized rings raise
   `RingOverflow`.
4. ``validate(backend="cuda", device="cpu")`` gives the reference backend's
   evidence: 14/17/35 replays and 3/8/12 negative rejections on
   jacobi-1d/jacobi-2d/heat-3d; wrong plans and undersized buffers raise.
5. The replay kernel's plain version, a tiled scan, gives the sequential
   walk's six counters exactly: on the verdict matrix and every stencil
   channel, at rings of 1, half the slots needed and all of them, in the
   three disciplines, in one tile and in tiles of a few events; and on
   random event lists (hypothesis).

The reference's own replay kernel does not run on this JAX version
(`pl.load` is gone), so the port is held against the reference's
``"reference"`` backend and its numpy `_build_events`.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.polybench  # noqa: F401,E402  (populate the registry)
import repro_torch.core.polybench  # noqa: F401,E402
from repro.core import analyze as ref_analyze  # noqa: E402
from repro.core.registry import get as ref_get  # noqa: E402
from repro.runtime import simulate_channel as ref_simulate  # noqa: E402
from repro.runtime import trace_channel as ref_trace  # noqa: E402
from repro.runtime.pallas_backend import _build_events as ref_events  # noqa: E402,E501
from repro_torch.core import Pattern, analyze  # noqa: E402
from repro_torch.core.registry import get  # noqa: E402
from repro_torch.runtime import (BROADCAST_REGISTER, FIFO_STREAM,  # noqa: E402
                                 LOWERINGS, REORDER_BUFFER, OrderViolation,
                                 ValidationError, backend,
                                 lowering_for_pattern, trace_channel)
from repro_torch.runtime.cuda_backend import (  # noqa: E402
    RingOverflow, _build_events, _replay_plain, _replay_walk, replay_events)

from test_runtime import CASES, two_proc_ppn as ref_two_proc_ppn  # noqa: E402
from test_torch_cuda import two_proc_ppn  # noqa: E402

STENCILS = {"jacobi-1d": (14, 3), "jacobi-2d": (17, 8), "heat-3d": (35, 12)}


def cuda_run(lowering, trace, **kw):
    return backend("cuda").implementation(lowering).run(trace, device="cpu",
                                                        **kw)


def assert_same_events(got, want):
    for f in ("kind", "value", "slot"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert got.needed == want.needed


# ------------------------------------------------------------ registry -----


def test_cuda_backend_covers_vocabulary_and_compiles():
    cb = backend("cuda")
    for name in LOWERINGS:
        impl = cb.implementation(name)
        assert impl.lowering == name
        assert hasattr(impl, "run")
    assert cb.compile is not None


# ------------------------------------------------------------- events -----


@pytest.mark.parametrize("src,verdict", CASES)
def test_build_events_byte_identical_on_verdict_matrix(src, verdict):
    ppn, ch = two_proc_ppn(src)
    rppn, rch = ref_two_proc_ppn(src)
    assert_same_events(_build_events(trace_channel(ppn, ch)),
                       ref_events(ref_trace(rppn, rch)))


@pytest.mark.parametrize("name", sorted(STENCILS))
def test_build_events_byte_identical_on_stencil_channels(name):
    a = analyze(get(name)).classify().fifoize().size().plan()
    r = ref_analyze(ref_get(name)).classify().fifoize().size().plan()
    sizing, rsizing = a.ctx.sizing(a.ppn), r.ctx.sizing(r.ppn)
    assert [c.name for c in a.ppn.channels] == [c.name for c in r.ppn.channels]
    for ch, rch in zip(a.ppn.channels, r.ppn.channels):
        trace = trace_channel(a.ppn, ch, sizing)
        if trace.num_edges == 0:
            continue
        assert_same_events(_build_events(trace),
                           ref_events(ref_trace(r.ppn, rch, rsizing)))


# ------------------------------------------------------ verdict matrix -----


@pytest.mark.parametrize("src,verdict", CASES)
def test_planned_lowering_executes_on_the_ring(src, verdict):
    ppn, ch = two_proc_ppn(src)
    rppn, rch = ref_two_proc_ppn(src)
    lowering = lowering_for_pattern(verdict)
    peak = cuda_run(lowering, trace_channel(ppn, ch))
    assert peak == ref_simulate(rppn, rch, lowering)


@pytest.mark.parametrize("src,verdict", CASES)
def test_cheaper_lowerings_reject_on_the_ring(src, verdict):
    verdict = Pattern(verdict.value)          # the reference's enum → port's
    ppn, ch = two_proc_ppn(src)
    trace = trace_channel(ppn, ch)
    if verdict is Pattern.FIFO:
        return
    with pytest.raises(OrderViolation):
        cuda_run(FIFO_STREAM, trace)
    if verdict in (Pattern.OOO, Pattern.OOO_UNICITY):
        with pytest.raises(OrderViolation):
            cuda_run(BROADCAST_REGISTER, trace)
    else:
        assert cuda_run(BROADCAST_REGISTER, trace) >= 1


def test_undersized_ring_overflows():
    ppn, ch = two_proc_ppn([0, 1, 2, 3])
    trace = trace_channel(ppn, ch)
    peak = cuda_run(FIFO_STREAM, trace)
    assert peak >= 1
    assert cuda_run(FIFO_STREAM, trace, slots=peak) == peak
    if peak > 1:
        with pytest.raises(RingOverflow, match="too small"):
            cuda_run(FIFO_STREAM, trace, slots=peak - 1)


def test_reorder_buffer_is_addressable_but_capacity_checked():
    ppn, ch = two_proc_ppn([1, 1, 0, 0])          # OOO trace
    trace = trace_channel(ppn, ch)
    assert cuda_run(REORDER_BUFFER, trace) >= 2
    with pytest.raises(RingOverflow):
        cuda_run(REORDER_BUFFER, trace, slots=1)


# ----------------------------------------------- Analysis.validate on cuda --


@pytest.mark.parametrize("name", sorted(STENCILS))
def test_validate_on_cuda_matches_reference_evidence(name):
    v = (analyze(get(name)).classify().fifoize().size().plan()
         .validate(backend="cuda", device="cpu").validation)
    want = (ref_analyze(ref_get(name)).classify().fifoize().size().plan()
            .validate(backend="reference").validation)
    assert (v.replays, v.rejections) == STENCILS[name]
    got, ref = v.as_dict(), want.as_dict()
    assert got.pop("backend") == "cuda" and ref.pop("backend") == "reference"
    assert got == ref


def test_validate_cuda_catches_wrong_plan():
    a = analyze(get("jacobi-1d")).classify().size(pow2=True).plan()
    broken = [p for p in a.plans if p.pattern_before != Pattern.FIFO.value
              and not p.split]
    assert broken
    bad = dataclasses.replace(broken[0], lowering=FIFO_STREAM)
    plans = tuple(bad if p.name == bad.name else p for p in a.plans)
    with pytest.raises(ValidationError, match="does not execute"):
        dataclasses.replace(a, plans=plans).validate(backend="cuda",
                                                     device="cpu")


def test_validate_cuda_catches_undersized_buffers():
    a = analyze(get("jacobi-1d")).classify().fifoize().size(pow2=True)
    shrunk = {k: max(0, v - 1) for k, v in a.sizes.items()}
    with pytest.raises(ValidationError, match="exceeds"):
        dataclasses.replace(a, sizes=shrunk).validate(backend="cuda",
                                                      device="cpu")


# ------------------------------------------- the replay's tiled scan -----

def assert_scan_equals_walk(ev, tiles=(4096, 3)):
    """`_replay_plain` (in tiles of each size) against `_replay_walk` on the
    event list ``ev`` at rings of 1, needed // 2 and needed slots, in the
    three disciplines (FIFO, REGISTER, REORDER)."""
    for ring in sorted({1, max(1, ev.needed // 2), ev.needed}):
        args = [torch.from_numpy(a.astype(np.int32))
                for a in (ev.kind, ev.value, ev.slot % ring)]
        for order_op in (0, 1, 2):
            want = _replay_walk(*args, ring, order_op).tolist()
            for tile in tiles:
                got = _replay_plain(*args, ring, order_op, tile=tile)
                assert got.tolist() == want, (ring, order_op, tile)


@pytest.mark.parametrize("src,verdict", CASES)
def test_replay_scan_equals_walk_on_verdict_matrix(src, verdict):
    ppn, ch = two_proc_ppn(src)
    assert_scan_equals_walk(_build_events(trace_channel(ppn, ch)))


@pytest.mark.parametrize("name", sorted(STENCILS))
def test_replay_scan_equals_walk_on_stencil_channels(name):
    a = analyze(get(name)).classify().fifoize().size().plan()
    sizing = a.ctx.sizing(a.ppn)
    for ch in a.ppn.channels:
        trace = trace_channel(a.ppn, ch, sizing)
        if trace.num_edges:
            assert_scan_equals_walk(_build_events(trace), tiles=(4096, 61))


@settings(max_examples=60, deadline=None)
@given(events=st.lists(st.tuples(st.integers(0, 3), st.integers(-2, 8),
                                  st.integers(0, 63)), max_size=300),
       ring=st.integers(1, 64), order_op=st.integers(0, 2),
       tile=st.sampled_from([1, 7, 64, 4096]))
def test_replay_scan_equals_walk_on_random_lists(events, ring, order_op,
                                                 tile):
    """Kinds 0–3 (push, pop, retire, NOOP), values in a small range, slots
    in a ring of 1–64 slots (so slots are touched many times in a tile and
    rings are undersized), 0–300 events."""
    kind, value, slot = (torch.tensor([e[i] for e in events],
                                      dtype=torch.int32) for i in range(3))
    slot = slot % ring
    want = _replay_walk(kind, value, slot, ring, order_op)
    assert torch.equal(_replay_plain(kind, value, slot, ring, order_op,
                                     tile=tile), want)
    assert torch.equal(replay_events(kind, value, slot, ring, order_op),
                       want)


def test_replay_events_checks_the_slots_of_cpu_tensors():
    kind = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside the ring"):
        replay_events(kind, kind, torch.tensor([0, 1, 2, 4],
                                               dtype=torch.int32), 4, 0)
    with pytest.raises(ValueError):
        replay_events(kind, kind, kind, 0, 0)
