"""The port's stencil compiler (`repro_torch.runtime.cuda_codegen`) against
the JAX package's pallas codegen.

1. The PyTorch oracles equal the jnp oracles.
2. On the `tests/test_pallas.py` geometries, at every block including the
   degenerate block = 1, the port's ``compile(device="cpu")`` output equals
   the JAX package's ``compile(backend="pallas", interpret=True)`` output
   and the oracle.
3. The undersized-ring and narrowed-halo injections give the SAME corrupted
   outputs as the Pallas kernel, elementwise, and both differ from the
   oracle: the plain version repeats the ring's aliasing exactly.
4. Mode selection, the addressable fallback and the errors mirror
   `tests/test_pallas.py`.

On the CPU every kernel wrapper runs its plain PyTorch version; inputs are
made with numpy and handed to both packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro.core.polybench  # noqa: F401,E402  (populate the registry)
import repro_torch.core.polybench  # noqa: F401,E402
from repro.core import analyze as ref_analyze  # noqa: E402
from repro.core.registry import get as ref_get  # noqa: E402
from repro_torch.core import analyze  # noqa: E402
from repro_torch.core.registry import get, kernel_names  # noqa: E402
from repro_torch.runtime import REORDER_BUFFER  # noqa: E402
from repro_torch.runtime.cuda_codegen import (  # noqa: E402
    MAX_CLUSTER, STENCIL_PROGRAMS, RingCard, _addressable_plain,
    _memory_channels, _ring_launch, addressable_step, addressable_steps,
    ring_launch, ring_stencil)

#: kernel → (shape, steps, blocks to try — 1 is the degenerate tiling)
from test_pallas import GEOMETRIES  # noqa: E402

ATOL = dict(rtol=1e-5, atol=1e-5)



def planned(name):
    return analyze(get(name)).classify().fifoize().size().plan()


def ref_planned(name):
    return ref_analyze(ref_get(name)).classify().fifoize().size().plan()


def inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(a, b) -> bool:
    return np.allclose(np.asarray(a), np.asarray(b), **ATOL)


# --------------------------------------------------------------- oracles ---


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_torch_oracles_match_jnp_oracles(name):
    from repro.runtime.pallas_codegen import STENCIL_PROGRAMS as REF_PROGRAMS

    shape, _, _ = GEOMETRIES[name]
    x = inputs(shape, 7)
    got = STENCIL_PROGRAMS[name].ref(torch.from_numpy(x), 5)
    want = REF_PROGRAMS[name].ref(jnp.asarray(x), 5)
    assert close(got, want)


# ---------------------------------------------------- generated kernels ----


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_generated_kernel_matches_pallas_and_oracle(name):
    shape, steps, blocks = GEOMETRIES[name]
    c = planned(name).compile(device="cpu")
    rc = ref_planned(name).compile(backend="pallas", interpret=True)
    assert c.mode == rc.mode == "fifo-ring", c.describe()
    x = inputs(shape, 0)
    want = c.program.ref(torch.from_numpy(x), steps)
    for block in blocks:
        got = c(x, steps, block)
        assert got.device.type == "cpu"
        assert close(got, rc(jnp.asarray(x), steps, block)), (name, block)
        assert close(got, want), (name, block)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_injected_rings_corrupt_exactly_like_pallas(name):
    """An undersized ring (``ring_depth=(steps+1)//2``) and a narrowed halo
    (``2r-1``) must corrupt the output — and corrupt it exactly as the
    Pallas kernel does, element for element."""
    shape, steps, blocks = GEOMETRIES[name]
    c = planned(name).compile(device="cpu")
    rc = ref_planned(name).compile(backend="pallas", interpret=True)
    x = inputs(shape, 2)
    want = c.program.ref(torch.from_numpy(x), steps)
    for block in blocks:
        for knob in ({"ring_depth": (steps + 1) // 2},
                     {"halo": 2 * c.program.radius - 1}):
            got = c(x, steps, block, **knob)
            ref = rc(jnp.asarray(x), steps, block, **knob)
            assert close(got, ref), (name, block, knob)
            assert not close(got, want), (name, block, knob)


def test_undersized_generated_ring_diverges():
    """The negative direction of `tests/test_pallas.py` at its own size."""
    c = planned("jacobi-1d").compile(device="cpu")
    steps = block = 8
    x = inputs(64, 2)
    want = c.program.ref(torch.from_numpy(x), steps)
    assert close(c(x, steps, block), want)
    assert not close(c(x, steps, block, ring_depth=(steps + 1) // 2), want)
    assert not close(c(x, steps, block, halo=2 * c.program.radius - 1), want)


def test_compile_mode_follows_the_plans():
    """Mirror of `tests/test_pallas.py::test_compile_mode_follows_the_plans`:
    a reorder-buffer plan on a compute channel forces the addressable
    fallback; memory (load/store) channels are exempt."""
    pre = analyze(get("jacobi-1d")).classify().size().plan()
    assert any(not p.is_cheap for p in pre.plans)       # load_A reorder plan
    assert pre.compile(device="cpu").mode == "fifo-ring"

    a = planned("jacobi-1d")
    victim = next(p for p in a.plans if p.name not in _memory_channels(a))
    bad = dataclasses.replace(victim, lowering=REORDER_BUFFER)
    forced = dataclasses.replace(
        a, plans=tuple(bad if p.name == victim.name else p for p in a.plans))
    c = forced.compile(device="cpu")
    assert c.mode == "addressable"
    assert c.diagnostics["reorder_plans"] == [victim.name]
    with pytest.raises(ValueError, match="reorder"):
        forced.compile(mode="fifo-ring")
    x = inputs(32, 3)
    assert close(c(x, 4, 4), c.program.ref(torch.from_numpy(x), 4))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_addressable_mode_matches_pallas(name):
    shape, steps, _ = GEOMETRIES[name]
    c = planned(name).compile(mode="addressable", device="cpu")
    rc = ref_planned(name).compile(backend="pallas", mode="addressable",
                                   interpret=True)
    x = inputs(shape, 4)
    got = c(x, steps, 1)
    assert close(got, rc(jnp.asarray(x), steps, 1))
    assert close(got, c.program.ref(torch.from_numpy(x), steps))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_addressable_job_on_the_cpu_chains_plain_steps(name):
    """The job entry point on a CPU tensor runs the plain version: ``steps``
    chained `_addressable_plain` calls, and ``x`` itself for 0 steps."""
    shape, steps, _ = GEOMETRIES[name]
    p = STENCIL_PROGRAMS[name]
    x = torch.from_numpy(inputs(shape, 6))
    want = x
    for n in range(1, steps + 2):
        want = _addressable_plain(want, p)
        assert torch.equal(addressable_steps(x, p, n), want)
    assert addressable_steps(x, p, 0) is x
    assert torch.equal(addressable_step(x, p), _addressable_plain(x, p))
    with pytest.raises(ValueError):
        addressable_steps(x, p, -1)


#: an H100 SXM as `ring_card` reads it: 132 SMs, 227 KB of shared memory a
#: CTA, and the ring kernel's launch bounds
H100 = RingCard(sms=132, smem_bytes=232448,
                max_threads={8: 512, 4: 1024, 2: 1024, 1: 1024})

#: (shape, block, depth, halo, ctas, mode) → (mode, CTAs, rows a CTA): the
#: main path's EXTRALARGE shapes at steps = block = 8 (heat-3d's tiles pass
#: a cluster's shared memory, so it takes a grid), the card tests' wide
#: shapes, a cluster cut to 4, and forced modes at 5 CTAs (None, None:
#: the public `ring_launch`)
LAUNCHES = [
    ((4000,), 8, 9, 2, None, None, ("shared", 1, 1)),
    ((2800, 2800), 8, 9, 2, None, None, ("shared", 16, 175)),
    ((200, 200, 200), 8, 9, 2, None, None, ("grid", 100, 2)),
    ((40, 300), 1, 5, 2, None, None, ("shared", 16, 19)),
    ((16, 37, 45), 2, 3, 1, None, None, ("shared", 13, 3)),
    ((2800, 2800), 8, 4, 2, 4, None, ("shared", 4, 700)),
    ((16, 37, 45), 2, 3, 2, None, "grid", ("grid", 37, 1)),
    ((16, 37, 45), 2, 3, 2, 5, "shared", ("shared", 5, 8)),
    ((16, 37, 45), 2, 3, 2, 5, "grid", ("grid", 5, 8)),
]


@pytest.mark.parametrize("shape,block,depth,halo,ctas,mode,want", LAUNCHES)
def test_ring_launch_shape(shape, block, depth, halo, ctas, mode, want):
    """The ring's rows spread over one cluster of at most 16 CTAs or a
    grid of at most one CTA an SM, every row owned once; threads ×
    segments fill at most a CTA; the tiles go to shared memory in a
    cluster where they fit, else to a global scratch."""
    L = (ring_launch(shape, block, depth, halo, H100)
         if ctas is None and mode is None else
         _ring_launch(shape, block, depth, halo, H100, ctas, mode))
    d1 = (shape[1:] + (1,))[0]
    d2 = (shape[2:] + (1,))[0]
    assert (L.mode, L.ctas, L.rows) == want
    assert L.ctas <= (ctas or (H100.sms if L.mode == "grid"
                               else MAX_CLUSTER))
    assert (L.ctas - 1) * L.rows < d1 <= L.ctas * L.rows
    assert L.stride % 32 == 0 and L.stride >= L.rows * d2
    assert L.tile_floats == (2 * depth * halo + 3 * (halo + block)) * L.stride
    assert block % L.segments == 0
    assert L.threads * L.segments <= H100.max_threads[block // L.segments]
    assert L.threads >= min(L.rows * d2, 32)
    if L.mode == "shared":
        assert L.smem_bytes == 4 * L.tile_floats <= H100.smem_bytes
        assert L.scratch_floats == 0
    else:
        assert L.smem_bytes == 0
        assert L.scratch_floats == L.ctas * L.tile_floats


def test_ring_launch_refuses_what_it_cannot_shape():
    with pytest.raises(ValueError, match="mode"):
        _ring_launch((16, 40), 4, 5, 2, H100, mode="vmem")
    with pytest.raises(ValueError, match="shared memory"):
        _ring_launch((200, 200, 200), 8, 9, 2, H100, mode="shared")


def test_compile_requires_plan_stage_and_known_program():
    with pytest.raises(ValueError, match="plan"):
        analyze(get("jacobi-1d")).classify().compile(device="cpu")
    with pytest.raises(KeyError, match="STENCIL_PROGRAMS"):
        planned("gemm").compile(device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        planned("jacobi-1d").compile(mode="vmem", device="cpu")


def test_compile_defaults_to_the_card():
    c = planned("jacobi-1d").compile()
    assert c.device == "cuda" and c.mode == "fifo-ring"
    assert planned("jacobi-1d").compile(device="cpu").device == "cpu"


def test_geometry_errors_are_loud():
    c = planned("jacobi-2d").compile(device="cpu")
    with pytest.raises(ValueError, match="rank"):
        c(inputs((16,), 0), 4, 4)
    with pytest.raises(ValueError, match="block"):
        c(inputs((18, 4), 0), 4, 4)
    with pytest.raises(ValueError, match="aligned"):
        c(inputs((16, 4), 0), 2, 4)


def test_wrappers_launch_or_raise_off_the_cpu():
    """A wrapper takes its plain version only for a CPU tensor; any other
    device must launch the kernel or raise — here a meta tensor raises."""
    p = STENCIL_PROGRAMS["jacobi-1d"]
    x = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ring_stencil(x, p, 4, 4, 5, 2)
    with pytest.raises(ValueError, match="no kernel"):
        addressable_step(x, p)


def test_measure_compiled_refuses_the_cpu():
    from repro_torch.runtime.cuda_backend import measure_compiled

    c = planned("jacobi-1d").compile(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        measure_compiled(c, 16, 4, 4)
    with pytest.raises(ValueError, match="block"):
        measure_compiled(c, 18, 4, 4)


@pytest.mark.parametrize("name,block,shape", [
    ("jacobi-1d", 8, (32,)), ("jacobi-2d", 2, (16, 4)),
    ("heat-3d", 8, (32, 8, 8))])
def test_measure_input_is_the_seeded_geometry(name, block, shape):
    """The array measure_compiled times (and chip_smoke checks again):
    inner widths max(4, block), standard normal from the seed."""
    from repro_torch.runtime.cuda_backend import measure_input

    x = measure_input(STENCIL_PROGRAMS[name], shape[0], block, "cpu", 3)
    want = np.random.default_rng(3).standard_normal(shape)
    assert x.dtype == torch.float32 and tuple(x.shape) == shape
    np.testing.assert_array_equal(x.numpy(), want.astype(np.float32))


def test_stencil_programs_mirror_registered_kernels():
    assert set(STENCIL_PROGRAMS) <= set(kernel_names())


def test_traffic_model_matches_reference():
    from repro.kernels.stencil_fifo.ops import hbm_traffic_model as ref_model
    from repro_torch.kernels.stencil_fifo import hbm_traffic_model

    for n, steps in ((4000, 8), (2800 * 2800, 1000)):
        assert hbm_traffic_model(n, steps) == ref_model(n, steps)
