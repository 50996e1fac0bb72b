"""The port's kernels 4–6 (`repro_torch.kernels`) against the JAX package's.

On the CPU each port function runs its plain PyTorch version; the JAX
kernels run in interpret mode, as `tests/test_kernels.py` runs them.  The
same numpy inputs go to both, and the tolerances are the reference's:

1. The hand-written Fig. 3 stencil (`jacobi_fifo`) equals the JAX kernel
   and the generated ring, and raises where the reference asserts; its
   plain version in the kernel's wave order equals the grid walk bit for
   bit; the launch holds the blocks in rounds of one CTA's workers; the
   kernel's division by 3 (an FMA-corrected product) is correctly
   rounded.
2. Flash attention's plain version equals the JAX kernel on the five
   `test_flash_attention_sweep` cases, the chunked oracles agree, and the
   result does not depend on the block shape.
3. The GLA time-mix's plain version and the sequential oracle equal the
   JAX ones on the three reference cases, the fast-decay case included,
   at hd = 128 and at a chunk that is no multiple of the kernel's
   sub-chunks; the plain version, which factors the decays between
   sub-chunks, stays finite and near the oracle at decay scale 1.5.
   Both wrappers' zero channels (the head widths the kernels are not built
   for) change nothing.
4. `attention_op` and `timemix_op` dispatch by device.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro_torch.core.polybench  # noqa: F401,E402  (populate the registry)
from repro.kernels import flash_attention as jax_fa  # noqa: E402
from repro.kernels import gla_timemix as jax_gla  # noqa: E402
from repro.kernels import stencil_fifo as jax_sf  # noqa: E402
from repro_torch.core import analyze  # noqa: E402
from repro_torch.core.registry import get  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_op, attention_ref, flash_attention)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    kernel as fa_kernel)
from repro_torch.kernels.gla_timemix import (  # noqa: E402
    gla_timemix, timemix_op, timemix_ref)
from repro_torch.kernels.gla_timemix import (  # noqa: E402
    kernel as gla_kernel)
from repro_torch.kernels.stencil_fifo import (  # noqa: E402
    jacobi_1d, jacobi_fifo, jacobi_fifo_op, jacobi_naive_op)
from repro_torch.kernels.stencil_fifo.kernel import (  # noqa: E402
    MAX_THREADS, _jacobi_fifo_plain, _jacobi_fifo_walk, fifo_launch)

ATOL = dict(rtol=1e-5, atol=1e-5)
_JNP_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
               torch.float16: jnp.float16}


def both(a: np.ndarray, dtype=torch.float32):
    """``a`` as a torch tensor and as a jax array, both of ``dtype``."""
    return (torch.from_numpy(a).to(dtype),
            jnp.asarray(a, _JNP_DTYPES[dtype]))


def as_np(a) -> np.ndarray:
    """A torch tensor or jax array as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------- kernel 4 ------

@pytest.mark.parametrize("n,bn", [(256, 32), (512, 64), (1024, 128)])
def test_jacobi_fifo_matches_jax_kernel(n, bn):
    x_t, x_j = both(np.random.default_rng(0).normal(size=(n,)).astype(
        np.float32))
    got = jacobi_fifo(x_t, steps=bn, block=bn)
    want = jax_sf.jacobi_fifo(x_j, steps=bn, block=bn)
    np.testing.assert_allclose(as_np(got), as_np(want), **ATOL)
    np.testing.assert_allclose(as_np(got), as_np(jacobi_1d(x_t, bn)), **ATOL)


def test_jacobi_fifo_matches_generated_ring():
    """`tests/test_pallas.py::test_generated_vs_handwritten_jacobi` on the
    port: the hand-written kernel and `compile(backend="cuda")`'s ring at
    the same tiling."""
    c = (analyze(get("jacobi-1d")).classify().fifoize().size().plan()
         .compile(backend="cuda", device="cpu"))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(64).astype(
        np.float32))
    got = c(x, 16, 16)
    hand = jacobi_fifo_op(x, steps=16, block=16)
    assert torch.allclose(got, hand, **ATOL)
    assert torch.equal(jacobi_naive_op(x, 16), jacobi_1d(x, 16))


@pytest.mark.parametrize("n,steps,block", [(64, 8, 16), (60, 16, 16),
                                           (64, 0, 0)])
def test_jacobi_fifo_rejects_what_the_reference_asserts(n, steps, block):
    with pytest.raises(ValueError):
        jacobi_fifo(torch.zeros(n), steps=steps, block=block)


@pytest.mark.parametrize("n,bn", [(8, 1), (64, 2), (99, 3), (256, 32),
                                  (1024, 128), (4000, 8)])
def test_jacobi_fifo_wave_order_equals_grid_walk(n, bn):
    """Every block on level t together, each reading the FIFO cells its
    left neighbour handed over at level t − 1, gives the Pallas grid walk's
    bits: block 1's broadcast FIFO and an odd block included."""
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(n,)).astype(
        np.float32))
    assert torch.equal(_jacobi_fifo_plain(x, bn, bn),
                       _jacobi_fifo_walk(x, bn, bn))


@pytest.mark.parametrize("n,bn,workers,tpw,rounds", [
    (4000, 8, 501, 2, 1),                 # PolyBench EXTRALARGE
    (1024, 128, 9, 32, 1), (4096, 256, 17, 32, 1),   # the Fig. 3 rows
    (8 * (MAX_THREADS - 1), 8, MAX_THREADS, 1, 1),
    (16000, 8, MAX_THREADS, 1, 2), (99, 3, 34, 1, 1), (66, 33, 3, 9, 1)])
def test_fifo_launch_holds_the_blocks_in_rounds(n, bn, workers, tpw, rounds):
    """The default launch: as many blocks in flight as the blocks (the
    flush block included) or one CTA's threads allow, 4 cells a thread
    where that keeps them in one round, else 8, and at least two where the
    block has two; the chain is rounds × steps levels."""
    launch = fifo_launch(n, bn)
    assert (launch.workers, launch.threads_per_worker,
            launch.rounds) == (workers, tpw, rounds)
    assert launch.waves == rounds * bn
    assert launch.threads <= MAX_THREADS and launch.threads % 32 == 0
    assert bn == 1 or bn // tpw >= 2


def _div3_fma(x: np.ndarray) -> np.ndarray:
    """``csrc/stencil_fifo.cu``'s div3 on float32 ``x``: q = RN(x·R),
    r = fma(−3, q, x), RN(q + r·R) with R = RN(1/3), the FMAs emulated
    exactly in float64 (the products are exact there; the last sum's
    rounding error is recovered by TwoSum and decides a float32 tie)."""
    third = np.float64(np.float32(1.0) / np.float32(3.0))
    x64 = x.astype(np.float64)
    q = (x64 * third).astype(np.float32).astype(np.float64)
    r = (x64 - 3.0 * q).astype(np.float32).astype(np.float64)
    t = r * third
    s = q + t
    e = (q - (s - (s - q))) + (t - (s - q))
    f = s.astype(np.float32)
    up = np.nextafter(f, np.float32(np.inf))
    dn = np.nextafter(f, np.float32(-np.inf))
    fd = f.astype(np.float64)
    f = np.where((s == (fd + up.astype(np.float64)) / 2) & (e > 0), up, f)
    f = np.where((s == (fd + dn.astype(np.float64)) / 2) & (e < 0), dn, f)
    return f


def test_fifo_kernel_division_is_correctly_rounded():
    """The kernel divides by 3 as an FMA-corrected product.  It equals
    RN(x / 3) on every float32 of [1, 2) and at the ends of the range where
    the kernel uses it (2^-100 ≤ |x| ≤ FLT_MAX); both sides scale by powers
    of two in between, so one binade stands for them all.  RN(x / 3) is
    float64's quotient rounded to float32: the double rounding is exact
    here, as x / 3 is never within 2^-53 of a float32 midpoint unless it
    is one."""
    one = np.float32(1.0).view(np.uint32)
    for start in range(int(one), int(one) + (1 << 23), 1 << 21):
        x = np.arange(start, start + (1 << 21), dtype=np.uint32).view(
            np.float32)
        want = (x.astype(np.float64) / 3.0).astype(np.float32)
        assert np.array_equal(_div3_fma(x), want)
    edges = np.concatenate([
        np.float32(2.0 ** -100) * (1 + np.arange(4096, dtype=np.float32)
                                   * np.float32(2.0 ** -23)),
        np.nextafter(np.float32(np.finfo(np.float32).max), np.float32(0),
                     dtype=np.float32) - np.arange(4096, dtype=np.float32)
        * np.float32(2.0 ** 104)])
    edges = np.concatenate([edges, -edges])
    want = (edges.astype(np.float64) / 3.0).astype(np.float32)
    assert np.array_equal(_div3_fma(edges), want)


# ---------------------------------------------------------- kernel 5 ------

def attention_inputs(B, S, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    return [both(rng.normal(size=s).astype(np.float32), dtype)
            for s in shapes]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,dt,tol", [
    (2, 128, 4, 2, 64, True, torch.float32, 1e-5),
    (1, 256, 8, 8, 128, True, torch.bfloat16, 2e-2),
    (2, 128, 4, 1, 64, False, torch.float32, 1e-5),
    (1, 128, 6, 3, 32, True, torch.float32, 1e-5),
    (1, 64, 2, 2, 128, True, torch.float16, 1e-2),
])
def test_flash_attention_matches_jax_kernel(B, S, H, KV, hd, causal, dt,
                                            tol):
    """`tests/test_kernels.py::test_flash_attention_sweep`'s cases: the
    port's plain version against the JAX kernel and both oracles, at the
    reference's tolerances."""
    (q, qj), (k, kj), (v, vj) = attention_inputs(B, S, H, KV, hd, dt, 7)
    got = flash_attention(q, k, v, causal=causal, bq=64, bk=64)
    assert got.dtype == dt and got.shape == (B, S, H, hd)
    want = jax_fa.flash_attention(qj, kj, vj, causal=causal, bq=64, bk=64)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)
    ref = attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(as_np(ref), as_np(
        jax_fa.attention_ref(qj, kj, vj, causal=causal)), atol=tol, rtol=tol)
    np.testing.assert_allclose(as_np(got), as_np(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("threads", [1, 2, 3, 5, 8])
def test_flash_attention_plain_is_exact_under_any_thread_count(threads):
    """The case that was sometimes off (6.1e-5 from a float64 reference in
    one (b, h) of the first q block, where the JAX kernel was 6.4e-7 off),
    run repeatedly under MKL thread counts: the plain version's products
    must not depend on the kernel or the threads MKL picks, so it stays
    within float32 rounding (2e-6) of the float64 reference."""
    (q, _), (k, _), (v, _) = attention_inputs(2, 128, 4, 2, 64,
                                              torch.float32, 7)
    want = attention_ref(q.double(), k.double(), v.double(), causal=True)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        for _ in range(3):
            got = flash_attention(q, k, v, causal=True, bq=64, bk=64)
            assert float((got.double() - want).abs().max()) <= 2e-6
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("hd,width", [(16, 32), (80, 128)])
def test_flash_attention_zero_channels_change_nothing(hd, width):
    """What the wrapper does on the card for a head width the kernel is not
    built for: q, k and v padded with zero channels to ``width``, the
    scale kept at the true hd's, the output sliced back."""
    assert fa_kernel.padded_width(hd) == width
    (q, _), (k, _), (v, _) = attention_inputs(1, 128, 4, 2, hd,
                                              torch.float32, 9)
    pad = [torch.nn.functional.pad(a, (0, width - hd)) for a in (q, k, v)]
    got = flash_attention(*pad, causal=True, bq=64, bk=64, scale=hd ** -0.5)
    want = flash_attention(q, k, v, causal=True, bq=64, bk=64)
    assert torch.allclose(got[..., :hd], want, **ATOL)
    assert not got[..., hd:].any()
    with pytest.raises(ValueError, match="up to 128"):
        fa_kernel.padded_width(129)


def test_flash_attention_block_shapes():
    """`tests/test_kernels.py::test_flash_attention_block_shapes` on the
    port: the result does not depend on the block shape."""
    (q, _), (k, _), (v, _) = attention_inputs(1, 256, 4, 2, 64,
                                              torch.float32, 3)
    outs = [flash_attention(q, k, v, causal=True, bq=bq, bk=bk)
            for bq, bk in ((32, 32), (64, 128), (128, 64), (256, 256))]
    for o in outs[1:]:
        assert torch.allclose(outs[0], o, **ATOL)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, bq=96, bk=64)


# ---------------------------------------------------------- kernel 6 ------

def gla_inputs(B, S, H, hd, decay_scale, seed=11):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, S, H, hd)) for _ in range(3)]
    arrs.append(-np.exp(rng.normal(size=(B, S, H, hd)) * decay_scale))
    arrs.append(rng.normal(size=(H, hd)))
    return [both(a.astype(np.float32)) for a in arrs]


@pytest.mark.parametrize("B,S,H,hd,chunk,decay_scale", [
    (2, 128, 3, 32, 32, 0.5),
    (1, 256, 2, 64, 64, 1.0),     # fast decays: overflow regression case
    (2, 128, 4, 16, 128, 1.5),
    (1, 128, 2, 128, 64, 1.0),    # hd = 128 at the default chunk
    (1, 96, 2, 16, 24, 1.0),      # a chunk padded to whole sub-chunks
])
def test_gla_timemix_matches_jax(B, S, H, hd, chunk, decay_scale):
    """`tests/test_kernels.py::test_gla_timemix_matches_sequential`'s cases:
    the port's plain version and sequential oracle against the JAX kernel
    and oracle, within the reference's 2e-3."""
    pairs = gla_inputs(B, S, H, hd, decay_scale)
    t_in = [t for t, _ in pairs]
    j_in = [j for _, j in pairs]
    got = gla_timemix(*t_in, chunk=chunk)
    assert bool(torch.isfinite(got).all())
    want = jax_gla.gla_timemix(*j_in, chunk=chunk)
    ref = timemix_ref(*t_in)
    tol = dict(atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)
    np.testing.assert_allclose(as_np(ref), as_np(jax_gla.timemix_ref(*j_in)),
                               **tol)
    np.testing.assert_allclose(as_np(got), as_np(ref), **tol)


@pytest.mark.parametrize("chunk", [64, 128])
def test_gla_timemix_factored_decays_stay_finite(chunk):
    """Decays drawn at scale 1.5 (cumulative decays far past e^88 within a
    chunk): the plain version, which factors the decays between
    sub-chunks through the last row of the earlier one, stays finite and
    within the reference's 2e-3 of the sequential oracle."""
    t_in = [t for t, _ in gla_inputs(1, 256, 2, 32, 1.5, seed=5)]
    got = gla_timemix(*t_in, chunk=chunk)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(as_np(got), as_np(timemix_ref(*t_in)),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("hd,width", [(8, 16), (20, 32), (100, 128)])
def test_gla_timemix_zero_channels_change_nothing(hd, width):
    """What the wrapper does on the card for a head width the kernel is not
    built for: every input padded with zero channels to ``width`` (zero
    r and k add no term, zero v gives zero columns, zero logw no decay),
    the output sliced back."""
    assert gla_kernel.padded_width(hd) == width
    t_in = [t for t, _ in gla_inputs(1, 64, 2, hd, 1.0)]
    pad = [torch.nn.functional.pad(a, (0, width - hd)) for a in t_in]
    got = gla_timemix(*pad, chunk=32)
    assert torch.allclose(got[..., :hd], gla_timemix(*t_in, chunk=32),
                          **ATOL)
    assert not got[..., hd:].any()
    with pytest.raises(RuntimeError, match="up to 128"):
        gla_kernel.padded_width(129)


def test_gla_timemix_rejects_bad_shapes():
    t_in = [t for t, _ in gla_inputs(1, 96, 2, 16, 0.5)]
    with pytest.raises(ValueError):
        gla_timemix(*t_in, chunk=64)
    with pytest.raises(ValueError):
        gla_timemix(*t_in[:4], t_in[4][:1], chunk=32)


# ---------------------------------------------------------- dispatch ------

def test_ops_dispatch_on_cpu():
    """On a CPU tensor ``use_kernel=None`` runs the oracle, ``True`` the
    kernel's plain version."""
    (q, _), (k, _), (v, _) = attention_inputs(1, 128, 4, 2, 32,
                                              torch.float32, 5)
    assert torch.equal(attention_op(q, k, v), attention_ref(q, k, v))
    assert torch.equal(attention_op(q, k, v, causal=False, use_kernel=True),
                       flash_attention(q, k, v, causal=False))
    t_in = [t for t, _ in gla_inputs(1, 128, 2, 16, 0.5)]
    assert torch.equal(timemix_op(*t_in), timemix_ref(*t_in))
    assert torch.equal(timemix_op(*t_in, chunk=32, use_kernel=True),
                       gla_timemix(*t_in, chunk=32))
