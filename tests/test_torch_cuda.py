"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels are CUDA C++ with no CPU mode.  The file imports neither jax nor
`repro`, so it runs on a host with PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because `tests/conftest.py` imports jax).  `chip_smoke.py`
makes the same comparisons, and more, at the main path's shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.ppn import PPN, Channel, Process  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    _flash_attention_plain, flash_attention)
from repro_torch.kernels.gla_timemix.kernel import (  # noqa: E402
    _gla_timemix_plain, gla_timemix)
from repro_torch.kernels.stencil_fifo.kernel import (  # noqa: E402
    MAX_THREADS, _jacobi_fifo_plain, _jacobi_fifo_walk, _jacobi_fifo_with,
    fifo_launch, jacobi_fifo)
from repro_torch.core.schedule import AffineSchedule  # noqa: E402
from repro_torch.dse import (PoolManager, default_experiment,  # noqa: E402
                             run_group)
from repro_torch.runtime import trace_channel  # noqa: E402
from repro_torch.runtime.cuda_backend import (  # noqa: E402
    REPLAY_TILE, _build_events, _replay_plain, _replay_walk, replay_events)
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.runtime.cuda_codegen import (  # noqa: E402
    RING_LAUNCHES, RING_MODES, STENCIL_PROGRAMS, _addressable_plain,
    _ring_launch, _ring_plain, _ring_stencil_with, addressable_step,
    addressable_steps, ring_card, ring_launch, ring_stencil)

ATOL = dict(rtol=1e-5, atol=1e-5)

#: kernel → (shape, steps, blocks); block = 1 is the degenerate tiling
GEOMETRIES = {
    "jacobi-1d": ((32,), 4, (1, 2, 4)),
    "jacobi-2d": ((16, 8), 4, (1, 4)),
    "heat-3d": ((8, 4, 4), 2, (1, 2)),
}
#: consumer read orders of the 2-process verdict matrix (tests/test_runtime.py)
READ_ORDERS = ([0, 1, 2, 3], [0, 0, 1, 1], [1, 0, 3, 2], [1, 1, 0, 0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_stencil_kernels_match_plain_versions(name, cuda_device):
    shape, steps, blocks = GEOMETRIES[name]
    p = STENCIL_PROGRAMS[name]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(shape)
                         .astype(np.float32)).to(cuda_device)
    for block in blocks:
        for depth, halo in ((steps + 1, 2), ((steps + 1) // 2, 2),
                            (steps + 1, 1)):
            got = ring_stencil(x, p, steps, block, depth, halo)
            want = _ring_plain(x, p, steps, block, depth, halo)
            torch.cuda.synchronize()
            assert torch.allclose(got, want, **ATOL), (block, depth, halo)
    assert torch.allclose(addressable_step(x, p), _addressable_plain(x, p),
                          **ATOL)


#: inner widths over several ring CTAs, a multiple of no tile: kernel →
#: (shape, steps)
WIDE = {"jacobi-2d": ((40, 300), 4), "heat-3d": ((16, 37, 45), 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", RING_MODES)
@pytest.mark.parametrize("name", sorted(WIDE))
def test_ring_kernel_over_many_ctas_matches_plain_version(name, mode,
                                                          cuda_device):
    """The ring's rows over 13-100 CTAs, in one cluster with the tiles in
    shared memory or in a cooperative grid with them in the global
    scratch, or its blocks over 9-11 CTAs in the wave: block 1 and block =
    steps, each with a full ring, an undersized one and a narrowed halo
    (in the wave mode the rings it does not take, block 1's, the
    undersized and the narrowed, through the mode `ring_launch` gives)."""
    shape, steps = WIDE[name]
    p = STENCIL_PROGRAMS[name]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(shape)
                         .astype(np.float32)).to(cuda_device)
    card = ring_card(cuda_device)
    assert _ring_launch(shape, steps, steps + 1, 2, card, mode=mode,
                        steps=steps).ctas > 1
    for block in (1, steps):
        for depth, halo in ((steps + 1, 2), ((steps + 1) // 2, 2),
                            (steps + 1, 1)):
            takes = mode != "wave" or (depth > steps and halo == 2
                                       and block > 1)
            got = _ring_stencil_with(x, p, steps, block, depth, halo,
                                     _ring_launch(shape, block, depth, halo,
                                                  card,
                                                  mode=mode if takes
                                                  else None,
                                                  steps=steps))
            want = _ring_plain(x, p, steps, block, depth, halo)
            torch.cuda.synchronize()
            assert torch.allclose(got, want, **ATOL), (block, depth, halo)


#: the wave mode's geometries, steps = block: kernel → [(shape, steps)]:
#: jacobi-2d's EXTRALARGE shape (351 blocks, 3 rounds on 132 SMs), fewer
#: blocks than SMs, a partial last round (134 blocks), n_items == block,
#: blocks of 2 and of 4 items, items of 2 and 4 columns a thread whose
#: cells are no multiple of them; jacobi-1d's EXTRALARGE shape; heat-3d
WAVE = {
    "jacobi-2d": [((2800, 2800), 8), ((40, 300), 4), ((1064, 64), 8),
                  ((8, 300), 8), ((24, 37), 2), ((32, 1001), 4),
                  ((16, 2001), 8)],
    "jacobi-1d": [((4000,), 8), ((24,), 2)],
    "heat-3d": [((16, 37, 45), 2), ((12, 20, 20), 4), ((16, 8, 8), 8)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,steps", [
    (name, shape, steps) for name, cases in sorted(WAVE.items())
    for shape, steps in cases])
def test_wave_mode_is_bit_equal_to_the_cluster_and_the_addressable_steps(
        name, shape, steps, cuda_device):
    """`ring_stencil` takes the wave for a full ring whose block fits one
    CTA, and its output equals, bit for bit, the cluster-barrier kernel's
    (forced to ``"shared"``) and ``steps`` addressable steps'."""
    p = STENCIL_PROGRAMS[name]
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(shape)
                         .astype(np.float32)).to(cuda_device)
    card = ring_card(cuda_device)
    assert ring_launch(shape, steps, steps + 1, 2, card, steps).mode == "wave"
    before = RING_LAUNCHES["wave"]
    got = ring_stencil(x, p, steps, steps, steps + 1, 2)
    cluster = _ring_stencil_with(
        x, p, steps, steps, steps + 1, 2,
        _ring_launch(shape, steps, steps + 1, 2, card, mode="shared"))
    addressable = addressable_steps(x, p, steps)
    torch.cuda.synchronize()
    assert RING_LAUNCHES["wave"] - before == 1
    assert torch.equal(got, cluster)
    assert torch.equal(got, addressable)


@pytest.mark.cuda
def test_wave_job_of_250_calls_equals_2000_addressable_steps(cuda_device):
    """The benchmark's jacobi-2d job (2800 x 2800, 2000 sweeps as 250
    chained calls of steps = block = 8) runs all 250 launches in the wave
    and ends bit-equal to 2000 addressable steps; heat-3d's EXTRALARGE
    job runs none in the wave (its block fits no CTA): all 250 in the
    grid."""
    p = STENCIL_PROGRAMS["jacobi-2d"]
    x = torch.rand((2800, 2800), generator=torch.Generator(
        device=cuda_device).manual_seed(3), device=cuda_device)
    before = dict(RING_LAUNCHES)
    launches = cuda_lib.RING_STENCIL.launches
    y = x
    for _ in range(250):
        y = ring_stencil(y, p, 8, 8, 9, 2)
    want = addressable_steps(x, p, 2000)
    torch.cuda.synchronize()
    assert cuda_lib.RING_STENCIL.launches - launches == 250
    assert RING_LAUNCHES["wave"] - before.get("wave", 0) == 250
    assert RING_LAUNCHES["shared"] == before.get("shared", 0)
    assert torch.equal(y, want)
    heat = STENCIL_PROGRAMS["heat-3d"]
    xh = torch.rand((200, 200, 200), device=cuda_device)
    before = dict(RING_LAUNCHES)
    for _ in range(250):
        xh = ring_stencil(xh, heat, 8, 8, 9, 2)
    torch.cuda.synchronize()
    assert RING_LAUNCHES["wave"] == before.get("wave", 0)
    assert RING_LAUNCHES["grid"] - before.get("grid", 0) == 250
    assert bool(torch.isfinite(xh).all())


@pytest.mark.cuda
def test_unplaceable_wave_is_refused(cuda_device):
    """A wave of more CTAs than the card's SMs (one CTA an SM: each holds
    a block of 8 x 2800 cells) is refused at its launch, and the next
    launch is clean and exact."""
    p = STENCIL_PROGRAMS["jacobi-2d"]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2400, 2800)).astype(np.float32)).to(cuda_device)
    card = ring_card(cuda_device)
    big = _ring_launch(tuple(x.shape), 8, 9, 2, card, ctas=300, mode="wave",
                       steps=8)
    assert big.mode == "wave" and big.ctas == 300 > card.sms
    with pytest.raises(RuntimeError):
        _ring_stencil_with(x, p, 8, 8, 9, 2, big)
    got = ring_stencil(x, p, 8, 8, 9, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, addressable_steps(x, p, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [
    ("jacobi-1d", (40,)), ("jacobi-1d", (37,)), ("jacobi-2d", (40, 300)),
    ("jacobi-2d", (9, 37)), ("heat-3d", (16, 37, 45)), ("heat-3d", (6, 5, 8)),
])
def test_addressable_job_matches_chained_plain_steps(name, shape,
                                                     cuda_device):
    """The job entry point (float4 rows where the contiguous width allows,
    scalar ones elsewhere) against chained plain steps, one launch a
    step."""
    p = STENCIL_PROGRAMS[name]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(shape)
                         .astype(np.float32)).to(cuda_device)
    want = x
    for steps in range(1, 6):
        want = _addressable_plain(want, p)
        before = cuda_lib.ADDRESSABLE_STEP.launches
        got = addressable_steps(x, p, steps)
        torch.cuda.synchronize()
        assert cuda_lib.ADDRESSABLE_STEP.launches - before == steps
        assert torch.allclose(got, want, **ATOL), steps


@pytest.mark.cuda
def test_ring_card_reads_the_device(cuda_device):
    """The ring's launch limits come from the device (its SMs and the
    shared memory a CTA may opt in to) and from the kernel's launch
    bounds."""
    card = ring_card(cuda_device)
    props = torch.cuda.get_device_properties(cuda_device)
    assert card.sms == props.multi_processor_count
    assert 48 * 1024 < card.smem_bytes <= 256 * 1024
    assert sorted(card.max_threads) == [1, 2, 4, 8]
    assert all(0 < n <= 1024 for n in card.max_threads.values())


@pytest.mark.cuda
def test_unplaceable_ring_launch_is_refused(cuda_device):
    """A cluster of more CTAs than Hopper places (16), and a cooperative
    grid of more 1024-thread CTAs than the card's SMs, are refused at their
    launch, with no fallback to fewer CTAs, and the next launch is
    clean."""
    p = STENCIL_PROGRAMS["jacobi-2d"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 300))
                         .astype(np.float32)).to(cuda_device)
    card = ring_card(cuda_device)
    many = _ring_launch(tuple(x.shape), 4, 5, 2, card, ctas=32)
    assert many.ctas == 30
    with pytest.raises(RuntimeError):
        _ring_stencil_with(x, p, 4, 4, 5, 2, many)
    heat = STENCIL_PROGRAMS["heat-3d"]
    xg = torch.zeros((4, 300, 1024), device=cuda_device)
    big = _ring_launch(tuple(xg.shape), 4, 5, 2, card, ctas=300, mode="grid")
    assert (big.ctas, big.threads * big.segments) == (300, 1024)
    with pytest.raises(RuntimeError):
        _ring_stencil_with(xg, heat, 4, 4, 5, 2, big)
    got = ring_stencil(x, p, 4, 4, 5, 2)
    torch.cuda.synchronize()
    assert torch.allclose(got, _ring_plain(x, p, 4, 4, 5, 2), **ATOL)


def two_proc_ppn(src_idx):
    """`tests/test_runtime.py::two_proc_ppn` built from the port's classes:
    the producer writes i=0..n-1 in order; consumer j reads src_idx[j]."""
    src = np.asarray(src_idx, dtype=np.int64)[:, None]
    m = len(src)
    prod = Process("prod", ("i",), AffineSchedule.identity(("i",)),
                   np.arange(int(src.max()) + 1, dtype=np.int64)[:, None],
                   stmt_rank=0)
    cons = Process("cons", ("j",), AffineSchedule.identity(("j",)),
                   np.arange(m, dtype=np.int64)[:, None], stmt_rank=1)
    ch = Channel("prod", "cons", 0, "a", src,
                 np.arange(m, dtype=np.int64)[:, None])
    return PPN("toy", {}, {"prod": prod, "cons": cons}, [ch]), ch


@pytest.mark.cuda
@pytest.mark.parametrize("reads", READ_ORDERS)
def test_replay_kernel_matches_plain_version(reads, cuda_device):
    ppn, ch = two_proc_ppn(reads)
    ev = _build_events(trace_channel(ppn, ch))
    for order_op in (0, 1, 2):
        for ring_size in (1, ev.needed):
            args = [torch.from_numpy(a.astype(np.int32))
                    for a in (ev.kind, ev.value, ev.slot % ring_size)]
            want = _replay_plain(*args, ring_size, order_op)
            got = replay_events(*(a.to(cuda_device) for a in args),
                                ring_size, order_op)
            assert got.cpu().tolist() == want.tolist()
            assert want.tolist() == _replay_walk(*args, ring_size,
                                                 order_op).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_replay_kernel_matches_walk_across_tiles(seed, cuda_device):
    """Seeded random lists of one to three tiles and some events more, in
    all three disciplines with NOOPs mixed in, against the sequential walk
    exactly: rings of 1 to 1024 slots (slots touched many times in a tile;
    undersized rings), and one of 65536 slots, past what the kernel keeps
    in shared memory."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 4)) * REPLAY_TILE + 7
    for ring_size in (1, int(rng.integers(2, 1025)), 65536):
        arrs = (rng.integers(0, 4, n), rng.integers(0, 64, n),
                rng.integers(0, ring_size, n))
        args = [torch.from_numpy(a.astype(np.int32)) for a in arrs]
        for order_op in (0, 1, 2):
            want = _replay_walk(*args, ring_size, order_op)
            got = replay_events(*(a.to(cuda_device) for a in args),
                                ring_size, order_op)
            assert got.cpu().tolist() == want.tolist(), (ring_size, order_op)


@pytest.mark.cuda
@pytest.mark.parametrize("n,bn", [(8, 1), (64, 2), (99, 3), (256, 32),
                                  (1024, 128), (4096, 2048), (16000, 8)])
def test_jacobi_fifo_kernel_matches_plain_version(n, bn, cuda_device):
    """Block 1 (the FIFO levels broadcast one cell), an odd block, a block
    wider than the CTA's 1024 threads hold at one cell each, and more
    blocks than one CTA's workers (16000 cells at block 8: two rounds)
    included.  The kernel divides by 3 exactly; the plain version on the
    card multiplies by PyTorch's rounded reciprocal, 3.0e-8 too large
    relative to 1/3, a bias that compounds over the steps (1.8e-5 at 2048
    steps, above 1e-5).  So the tolerance is rtol = steps * 2**-22
    (`chip_smoke.py`'s TOL_LONG rule), at least 1e-5.  On the CPU, where
    PyTorch divides exactly, the grid walk gives the kernel's bits."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n)
                         .astype(np.float32)).to(cuda_device)
    got = jacobi_fifo(x, bn, bn)
    want = _jacobi_fifo_plain(x, bn, bn)
    torch.cuda.synchronize()
    assert torch.allclose(got, want, rtol=max(1e-5, bn * 2 ** -22),
                          atol=1e-5)
    assert torch.equal(got.cpu(), _jacobi_fifo_walk(x.cpu(), bn, bn))


@pytest.mark.cuda
@pytest.mark.parametrize("n,bn,workers,tpw", [
    (99, 3, 5, None), (256, 32, 2, None), (256, 32, 3, 8), (1024, 128, 2, 32),
    (96, 24, 3, None), (40, 8, 1, None), (66, 33, None, None),
    (8 * (MAX_THREADS - 1), 8, None, None)])
def test_jacobi_fifo_kernel_in_rounds_equals_walk(n, bn, workers, tpw,
                                                  cuda_device):
    """Forced launches: few workers, so the blocks run in rounds and the
    last worker's FIFO wraps to worker 0; uneven splits of a block over
    its threads; channels between many warps; exactly as many blocks as
    one CTA's workers.  Bit for bit against the CPU grid walk."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n)
                         .astype(np.float32))
    launch = fifo_launch(n, bn, workers, tpw)
    got = _jacobi_fifo_with(x.to(cuda_device), bn, bn, launch)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), _jacobi_fifo_walk(x, bn, bn)), launch


#: `tests/test_kernels.py::test_flash_attention_sweep`'s cases; ragged
#: causal cases (S = 96 and 64, below the kernel's 128-row tiles; B = 2 at
#: S = 192, where a tile past S must not read the next sequence's rows);
#: qwen2-7b's 7:1 grouping; bf16 and f16 at every head width; non-causal
#: bf16 (the tensor-core path)
ATTENTION_CASES = [
    (2, 128, 4, 2, 64, True, torch.float32, 1e-5),
    (1, 256, 8, 8, 128, True, torch.bfloat16, 2e-2),
    (2, 128, 4, 1, 64, False, torch.float32, 1e-5),
    (1, 128, 6, 3, 32, True, torch.float32, 1e-5),
    (1, 64, 2, 2, 128, True, torch.float16, 1e-2),
    (1, 96, 4, 2, 64, True, torch.float32, 1e-5),
    (2, 192, 4, 2, 64, True, torch.bfloat16, 2e-2),
    (2, 192, 4, 2, 128, True, torch.float16, 1e-2),
    (2, 192, 4, 2, 64, True, torch.float32, 1e-5),
    (1, 128, 28, 4, 128, True, torch.bfloat16, 2e-2),
    (1, 128, 28, 4, 128, True, torch.float32, 1e-5),
    (1, 128, 4, 2, 32, True, torch.bfloat16, 2e-2),
    (1, 128, 4, 2, 64, True, torch.bfloat16, 2e-2),
    (1, 128, 4, 2, 32, True, torch.float16, 1e-2),
    (1, 128, 4, 2, 64, True, torch.float16, 1e-2),
    (2, 256, 4, 2, 128, False, torch.bfloat16, 2e-2),
    # head widths the kernel runs on zero-padded channels
    (1, 128, 4, 2, 16, True, torch.float32, 1e-5),
    (1, 128, 4, 2, 16, True, torch.bfloat16, 2e-2),
    (2, 192, 4, 2, 80, True, torch.float32, 1e-5),
    (2, 192, 4, 2, 80, True, torch.bfloat16, 2e-2),
    # the server's prompts, shorter than one tile, at B = 4 and qwen2-7b's
    # width: a tensor map per sequence, bounded at S
    (4, 4, 28, 4, 128, True, torch.bfloat16, 2e-2),
    (4, 13, 28, 4, 128, True, torch.bfloat16, 2e-2),
    (4, 23, 28, 4, 128, True, torch.bfloat16, 2e-2),
    # whisper-medium's encoder: non-causal over 1500 frames, a ragged last
    # tile
    (1, 1500, 16, 16, 64, False, torch.bfloat16, 2e-2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,causal,dt,tol", ATTENTION_CASES)
def test_flash_attention_kernel_matches_plain_version(B, S, H, KV, hd, causal,
                                                      dt, tol, cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, dt)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    got = flash_attention(q, k, v, causal=causal)
    # the plain version's blocks: S's largest divisor up to 32
    blk = max(d for d in range(1, 33) if S % d == 0)
    want = _flash_attention_plain(q, k, v, causal=causal, bq=blk, bk=blk)
    torch.cuda.synchronize()
    assert got.dtype == dt
    assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_attention_refuses_heads_past_128(cuda_device):
    """hd > 128, past the widest head the kernel is built for, is refused
    with a ValueError that names the limit."""
    q = torch.zeros((1, 128, 2, 144), device=cuda_device)
    with pytest.raises(ValueError, match="up to 128"):
        flash_attention(q, q, q, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_unaligned_views(dt, cuda_device):
    """Views that start one element into their storage: the tensor maps and
    float4 loads need 16-byte aligned bases, so the wrapper copies them."""
    rng = np.random.default_rng(3)
    flat = [torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32))
            .to(cuda_device, dt) for n in (128 * 4 * 64, 128 * 2 * 64,
                                           128 * 2 * 64)]
    q, k, v = (f[1:].view(1, 128, h, 64) for f, h in zip(flat, (4, 2, 2)))
    assert q.data_ptr() % 16
    got = flash_attention(q, k, v, causal=True)
    want = _flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = 1e-5 if dt == torch.float32 else 2e-2
    assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,chunk,decay_scale,dt", [
    (2, 128, 3, 32, 32, 0.5, torch.float32),
    (1, 256, 2, 64, 64, 1.0, torch.float32),
    (2, 128, 4, 16, 128, 1.5, torch.float32),
    (1, 128, 2, 64, 64, 1.0, torch.bfloat16),
    # hd = 128 at the default chunk (its tiles once passed a CTA's shared
    # memory), chunk 16 at hd 16, and a padded hd with a chunk that is no
    # multiple of the kernel's 16-row sub-chunks
    (1, 128, 2, 128, 64, 1.0, torch.float32),
    (1, 128, 2, 128, 64, 1.0, torch.bfloat16),
    (1, 64, 2, 16, 16, 1.0, torch.float32),
    (1, 96, 2, 20, 24, 1.0, torch.float32),
])
def test_gla_timemix_kernel_matches_plain_version(B, S, H, hd, chunk,
                                                  decay_scale, dt,
                                                  cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    arrs = [rng.normal(size=(B, S, H, hd)) for _ in range(3)]
    arrs.append(-np.exp(rng.normal(size=(B, S, H, hd)) * decay_scale))
    arrs.append(rng.normal(size=(H, hd)))
    r, k, v, logw, u = (torch.from_numpy(a.astype(np.float32))
                        .to(cuda_device, dt) for a in arrs)
    got = gla_timemix(r, k, v, logw, u, chunk=chunk)
    want = _gla_timemix_plain(r, k, v, logw, u, chunk=chunk)
    torch.cuda.synchronize()
    # float32: the reference's 2e-3; bf16: the outputs are rounded to bf16
    # (a relative step of up to 2**-7) from float32 sums taken in another
    # order, so the reference's bf16 attention tolerance, 2e-2
    tol = 2e-3 if dt == torch.float32 else 2e-2
    assert got.dtype == dt and bool(torch.isfinite(got).all())
    assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_oversized_shared_memory_is_refused(cuda_device):
    """A tile whose shared memory passes what a CTA may hold (227 KB) is
    refused at its launch, and the refusal does not leak into the next
    launch: the wrappers have no shared-memory check of their own.  A Fig.
    3 block of 30000 cells would take 3,750 threads and 480 KB of FIFO; a
    time-mix chunk of 256 at hd 128, 414 KB in its first phase and 678 KB
    in its last."""
    x = torch.zeros(30000, device=cuda_device)
    with pytest.raises(RuntimeError):
        jacobi_fifo(x, 30000, 30000)
    r = torch.zeros((1, 256, 1, 128), device=cuda_device)
    u = torch.zeros((1, 128), device=cuda_device)
    with pytest.raises(RuntimeError):
        gla_timemix(r, r, r, r, u, chunk=256)
    small = torch.ones(64, device=cuda_device)
    torch.cuda.synchronize()
    assert torch.allclose(jacobi_fifo(small, 2, 2),
                          _jacobi_fifo_plain(small, 2, 2), **ATOL)
    rs = torch.ones((1, 64, 1, 16), device=cuda_device)
    got = gla_timemix(rs, rs, rs, -rs, rs[0, 0], chunk=64)
    assert torch.allclose(got, _gla_timemix_plain(rs, rs, rs, -rs, rs[0, 0],
                                                  chunk=64),
                          rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_gla_timemix_refuses_heads_past_128(cuda_device):
    """hd > 128, past the widest head the kernel is built for, is refused
    with a RuntimeError that names the limit."""
    r = torch.zeros((1, 64, 1, 160), device=cuda_device)
    with pytest.raises(RuntimeError, match="up to 128"):
        gla_timemix(r, r, r, r, r[0, 0], chunk=64)


def _measured_group(name: str) -> dict:
    """The first group of a one-tiling DSE over ``name`` (tile size 2,
    sequential), its first size point measured on the card."""
    exp = default_experiment("card", kernels=[name], tile_sizes=[2],
                             topologies=["sequential"], size_count=1,
                             measure={"kernels": [name], "repeats": 1,
                                      "max_points": 1})
    return exp.groups()[0].as_dict()


def _assert_measured_on_the_card(results) -> None:
    first = results[0]
    assert "error" not in first, first.get("error")
    assert not [n for n in first["provenance"]["notes"]
                if n.startswith("measure skipped")]
    m = first["measured"]
    assert m["device"] == torch.cuda.get_device_name(0)
    assert m["mode"] in ("fifo-ring", "addressable") and m["seconds"] > 0
    assert first["metrics"]["measured_s"] == m["seconds"]
    assert all("measured" not in r for r in results[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STENCIL_PROGRAMS))
def test_dse_group_is_measured_on_the_card(name, cuda_device):
    before = cuda_lib.RING_STENCIL.launches
    results = run_group(_measured_group(name))
    _assert_measured_on_the_card(results)
    m = results[0]["measured"]
    assert m["calls"] >= 2                       # the warm-up and 1 timed
    if m["mode"] == "fifo-ring":
        assert cuda_lib.RING_STENCIL.launches - before == m["calls"]


@pytest.mark.cuda
def test_dse_pool_measures_after_cuda_is_live(cuda_device):
    """Pool workers are spawned: a measured group still runs on the card
    after this process has initialised CUDA (a forked child could not)."""
    torch.zeros(1, device=cuda_device)
    torch.cuda.synchronize()
    pool = PoolManager(max_workers=1)
    try:
        pool.submit("jacobi-1d", _measured_group("jacobi-1d"))
        (task_id, results), = list(pool.drain())
    finally:
        pool.close()
    assert task_id == "jacobi-1d"
    _assert_measured_on_the_card(results)


# ------------------------------------------------ wire faults on the card --

def _planned_gemm():
    import repro_torch.core.polybench  # noqa: F401  (populate the registry)
    from repro_torch.core import analyze
    from repro_torch.core.registry import get
    return analyze(get("gemm")).classify().fifoize().size(pow2=True).plan(
        topology="sequential")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["drop", "duplicate", "reorder"])
def test_gemm_wire_faults_are_rejected_on_the_card(kind, cuda_device):
    from repro_torch.runtime.lowering import FIFO_STREAM
    from repro_torch.runtime.resilience import (
        Fault, GuardViolation, expected_pop_counts, faulted_trace,
        guarded_replay)

    a = _planned_gemm()
    ch = next(c for c in a.ppn.channels if c.name == "init->upd.C[0]")
    tr = trace_channel(a.ppn, ch, a.ctx.sizing(a.ppn))
    exp = expected_pop_counts(tr)
    assert guarded_replay(tr, FIFO_STREAM, "cuda", expected=exp,
                          device=cuda_device) == guarded_replay(
        tr, FIFO_STREAM, "cuda", expected=exp, device="cpu")
    before = cuda_lib.REPLAY.launches
    with pytest.raises(GuardViolation) as exc:
        guarded_replay(faulted_trace(tr, Fault(kind, tr.channel, 1)),
                       FIFO_STREAM, "cuda", expected=exp,
                       device=cuda_device)
    assert exc.value.channel == "init->upd.C[0]"
    assert cuda_lib.REPLAY.launches - before == 1


def _jacobi_1d():
    import repro_torch.core.polybench  # noqa: F401  (populate the registry)
    from repro_torch.core import analyze
    from repro_torch.core.registry import get
    return analyze(get("jacobi-1d")).classify().fifoize().size(pow2=True)


@pytest.mark.cuda
def test_jacobi_1d_trace_matrix_on_the_card(cuda_device):
    from repro_torch.runtime.resilience import faults_validate, wire_faults

    a = _jacobi_1d()
    cases = wire_faults(a)
    cuda_lib.REPLAY.launches = 0
    v = faults_validate(a)                   # the card: no device named
    rows = {b: [r for r in v.trace_matrix if r["backend"] == b]
            for b in ("reference", "cuda")}
    assert len(rows["cuda"]) == len(rows["reference"]) == 10
    assert all(r["detected"] for r in v.trace_matrix)
    assert ([r["fault"] for r in rows["cuda"]]
            == [r["fault"] for r in rows["reference"]])
    assert cuda_lib.REPLAY.launches == sum(1 for c in cases
                                           if c.trace.num_edges)
    on_cpu = faults_validate(a, device="cpu")
    assert on_cpu.trace_matrix == v.trace_matrix


@pytest.mark.cuda
def test_replay_kernel_matches_walk_on_faulted_traces(cuda_device):
    from repro_torch.runtime import cuda_backend as cb
    from repro_torch.runtime.lowering import backend
    from repro_torch.runtime.resilience import wire_faults

    for a in (_jacobi_1d(), _planned_gemm()):
        for case in wire_faults(a):
            ev = cb.ring_events(case.trace)
            op = backend("cuda").implementation(case.lowering).order_op
            ts = [torch.from_numpy(x) for x in (ev.kind, ev.value, ev.slot)]
            want = _replay_walk(*ts, ev.ring, op).tolist()
            got = replay_events(*(t.to(cuda_device) for t in ts), ev.ring,
                                op).tolist()
            assert got == want, case.fault.spec()


@pytest.mark.cuda
def test_selftimed_backend_refuses_the_card(cuda_device):
    a = _jacobi_1d().plan()
    with pytest.raises(ValueError, match="host"):
        a.compile(backend="selftimed", device="cuda")
    with pytest.raises(ValueError, match="host"):
        a.compile(backend="selftimed", device=cuda_device)
    assert a.compile(backend="selftimed").run().completed


@pytest.mark.cuda
@pytest.mark.parametrize("selection", ["plans", "reorder-buffer",
                                       "cuda:ppermute"])
def test_pipeline_on_the_card_matches_its_cpu_run(selection, cuda_device):
    """Four stages on one card (`LocalGroup(4, "cuda")`), TF32 off, against
    the same code on the CPU, at the reference test's shape."""
    import torch_ranks
    from repro_torch.comm import LocalGroup

    S, D, M, mb = 4, 16, 8, 4
    rng = np.random.default_rng(19)
    params = {"w": (0.5 * rng.standard_normal((S, D, D))).astype(np.float32),
              "b": (0.1 * rng.standard_normal((S, D))).astype(np.float32)}
    xs, tg = (torch.from_numpy(rng.standard_normal((M, mb, D)).astype(
        np.float32)) for _ in range(2))
    kwargs = torch_ranks.selection_kwargs(selection, S, M)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = torch_ranks.pipeline_grads(LocalGroup(4, cuda_device), params,
                                         xs, tg, **kwargs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = torch_ranks.pipeline_grads(LocalGroup(4, "cpu"), params, xs, tg,
                                      **kwargs)
    assert got[0].device.type == "cuda"
    assert abs(float(got[0]) - float(want[0])) <= 1e-6
    for k in ("w", "b"):
        assert torch.allclose(got[1][k].cpu(), want[1][k], rtol=0,
                              atol=1e-6), k


def _reduced_model(arch: str):
    """The port's model at ``arch``'s reduced config, its serving rules, and
    its parameters (seed 1) in float32 on the CPU."""
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.models import Rules, build
    from repro_torch.tree import tree_map

    bundle = configs.get(arch)
    par = bundle.parallel_for("decode_32k", multi_pod=False)
    model = build(reduced(bundle.model), par)
    params = tree_map(lambda a: a.float() if a.is_floating_point() else a,
                      model.init(1, "cpu"))
    return model, Rules.make({"data": 1, "model": 1}, par), params


def _to(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda a: a.to(device), tree)


def _tokens(model, B: int, S: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, model.cfg.vocab_size, (B, S)).astype(np.int32))


#: the model's float32 outputs on the card against the CPU, relative to the
#: largest one: kernel 5 or 6 (products in three TF32 passes, about 20
#: bits) in place of the chunked forms and cuBLAS with TF32 off, at the
#: init's scale (the stacked (D, heads, hd) projections take the head
#: count as their fan-in, as the reference draws them, so q and k have an
#: RMS of about 4 at the reduced width and the scores of about 16, which
#: the softmax turns into relative errors of 1e-5 and more)
MODEL_REL = 1e-4


def _rel_err(got, want) -> float:
    got, want = got.cpu().float(), want.cpu().float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("S", [16, 13])
def test_model_attention_on_the_card_matches_the_cpu(mode, S, cuda_device):
    """`models.attention.attention` of one reduced qwen2-7b layer: kernel 5
    on the card (one launch), `chunked_attention` on the CPU; prefill's
    cache write too."""
    from repro_torch.models.attention import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    model, rules, params = _reduced_model("qwen2-7b")
    lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    cfg = model.cfg
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32))
    pos = torch.arange(S)[None].expand(2, S)
    cache = {k: v.float() for k, v in model.init_cache(2, 32, "cpu").items()}
    want, want_cache = attention(lp, x, cfg, rules, mode, pos, dict(cache),
                                 layer_idx=0)
    before = cuda_lib.FLASH_ATTENTION.launches
    got, got_cache = attention(_to(lp, cuda_device), x.to(cuda_device), cfg,
                               rules, mode, pos.to(cuda_device),
                               _to(cache, cuda_device), layer_idx=0)
    torch.cuda.synchronize()
    assert cuda_lib.FLASH_ATTENTION.launches - before == 1
    err = _rel_err(got, want)
    assert err <= MODEL_REL, err
    if mode == "prefill":
        for k in want_cache:
            assert _rel_err(got_cache[k], want_cache[k]) <= MODEL_REL, k


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 130])
def test_model_time_mix_on_the_card_matches_the_cpu(S, cuda_device):
    """`models.rwkv.apply_time_mix` of one reduced rwkv6-1.6b layer in train
    mode, its bonus u drawn: kernel 6 on the card (one launch) at the
    model's chunk, the chunked form on the CPU (one chunk at S = 16, five
    at S = 130)."""
    from repro_torch.models.rwkv import apply_time_mix

    torch.backends.cuda.matmul.allow_tf32 = False
    model, rules, params = _reduced_model("rwkv6-1.6b")
    lp = {k: v[0] for k, v in params["layers"]["tm"].items()}
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(
        (1, S, model.cfg.d_model)).astype(np.float32))
    # the bonus u, which the init sets to 0, drawn so that it enters
    lp["u"] = torch.from_numpy(rng.standard_normal(
        tuple(lp["u"].shape)).astype(np.float32))
    want, _ = apply_time_mix(lp, x, model.cfg, rules, "train", None)
    before = cuda_lib.GLA_TIMEMIX.launches
    got, state = apply_time_mix(_to(lp, cuda_device), x.to(cuda_device),
                                model.cfg, rules, "train", None)
    torch.cuda.synchronize()
    assert cuda_lib.GLA_TIMEMIX.launches - before == 1 and state is None
    assert torch.allclose(got.cpu(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kernel", [("qwen2-7b", "FLASH_ATTENTION"),
                                         ("rwkv6-1.6b", "GLA_TIMEMIX")])
def test_model_forward_launches_its_kernel_once_a_layer(arch, kernel,
                                                         cuda_device):
    """A train forward on the card launches its kernel once per layer and
    the other model kernel never, and its logits match the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model, rules, params = _reduced_model(arch)
    toks = _tokens(model, 2, 16, 8)
    want = model.forward(params, {"tokens": toks}, rules, "train")[0]
    counted = (cuda_lib.FLASH_ATTENTION, cuda_lib.GLA_TIMEMIX)
    before = [k.launches for k in counted]
    got = model.forward(_to(params, cuda_device),
                        {"tokens": toks.to(cuda_device)}, rules, "train")[0]
    torch.cuda.synchronize()
    rise = {k.symbol: k.launches - b for k, b in zip(counted, before)}
    mine = getattr(cuda_lib, kernel).symbol
    assert rise == {s: (model.cfg.num_layers if s == mine else 0)
                    for s in rise}
    assert _rel_err(got, want) <= MODEL_REL


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "llama3-405b", "rwkv6-1.6b"])
def test_model_prefill_decode_on_the_card(arch, cuda_device):
    """Prefill S − 1 tokens and decode token S on the card, the cache in
    float32 (int8 with float32 scales for llama3-405b's serving config): the
    decode logits match the CPU's run of the same pair and the card's own
    train forward at the last position.  int8 KV adds ~1/127 of each K/V
    row's largest element: against the CPU a code may move by one where
    the card's K/V sit at a rounding tie (`tests/test_models.py`'s float32
    int8 bar, atol 0.05), against the forward the quantization itself
    (its bar, atol 0.6, rtol 0.1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model, rules, params = _reduced_model(arch)
    int8 = model.par.kv_cache_dtype == "int8"
    B, S = 2, 24
    toks = _tokens(model, B, S, 9)

    def pair(device, params):
        cache = {k: v.float() if v.is_floating_point() else v
                 for k, v in model.init_cache(B, S, device).items()}
        _, cache = model.prefill_fn(params, {"tokens": toks[:, :S - 1].to(
            device)}, rules, cache)
        logits, cache = model.decode_fn(
            params, {"tokens": toks[:, S - 1:].to(device), "pos": S - 1},
            cache, rules)
        return logits[:, 0], cache

    with torch.no_grad():
        want, want_cache = pair("cpu", params)
        gparams = _to(params, cuda_device)
        got, got_cache = pair(cuda_device, gparams)
        full = model.forward(gparams, {"tokens": toks.to(cuda_device)},
                             rules, "train")[0][:, -1]
    torch.cuda.synchronize()
    if int8:
        assert float((got_cache["k"].cpu().int() - want_cache["k"].int())
                     .abs().max()) <= 1
        assert torch.allclose(got.cpu(), want, atol=0.05, rtol=0)
        assert torch.allclose(got, full, atol=0.6, rtol=0.1)
    else:
        assert _rel_err(got, want) <= MODEL_REL
        assert _rel_err(got, full) <= MODEL_REL


#: a model's float32 gradients on the card against the CPU's, of each leaf's
#: largest entry: the forward runs kernels 5 and 6 on the card and the
#: chunked forms on the CPU (`MODEL_REL` apart in logits), the backward the
#: chunked forms' autograd on both, its sums in another order (the CPU
#: port against the JAX package reads up to 5.2e-5 from sum order alone,
#: `tests/test_torch_train.py`)
GRAD_REL = 2e-4


def _grad_err(got, want) -> float:
    got, want = got.cpu().float(), want.cpu().float()
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-7b", "rwkv6-1.6b"])
def test_model_loss_fn_gradients_on_the_card_match_the_cpu(arch,
                                                           cuda_device):
    """`Model.loss_fn(...).backward()` on the card gives every floating
    parameter a gradient (attention's q/k/v projections and biases, and the
    time-mix's, reach the loss only through kernels 5 and 6), each within
    `GRAD_REL` of the CPU's; the kernel launches twice a layer (the forward
    and remat's recompute)."""
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    model, rules, params = _reduced_model(arch)
    toks = _tokens(model, 2, 16, 10)

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, f"{path}[{key!r}]").items()}
        return {path: tree}

    def grads(device):
        p = tree_map(lambda a: a.detach().to(device, copy=True)
                     .requires_grad_(a.is_floating_point()), params)
        total, _ = model.loss_fn(p, {"tokens": toks.to(device)}, rules)
        total.backward()
        return total, flat(p)

    counted = (cuda_lib.FLASH_ATTENTION, cuda_lib.GLA_TIMEMIX)
    want_total, want = grads("cpu")
    before = [k.launches for k in counted]
    got_total, got = grads(cuda_device)
    torch.cuda.synchronize()
    rise = [k.launches - b for k, b in zip(counted, before)]
    missing = [k for k, p in got.items() if p.grad is None]
    assert not missing, f"no gradient on the card for {missing}"
    errs = {k: _grad_err(got[k].grad, want[k].grad) for k in want}
    assert max(errs.values()) <= GRAD_REL, errs
    assert _rel_err(got_total, want_total) <= MODEL_REL
    L = model.cfg.num_layers
    assert rise == ([0, 2 * L] if model.cfg.family == "ssm" else [2 * L, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradients_are_the_chunked_forms(causal, hd, dt,
                                                         cuda_device):
    """Kernel 5's `autograd.Function`: one launch forward, and the
    gradients of `chunked_attention` on the same q, k, v and upstream
    gradient, at a ragged S."""
    from repro_torch.kernels.flash_attention.ref import chunked_attention

    rng = np.random.default_rng(hd)

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, dt)

    q, k, v = (draw(s).requires_grad_() for s in ((2, 130, 4, hd),
                                                  (2, 130, 2, hd),
                                                  (2, 130, 2, hd)))
    g = draw((2, 130, 4, hd))
    before = cuda_lib.FLASH_ATTENTION.launches
    out = flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert cuda_lib.FLASH_ATTENTION.launches - before == 1
    want = torch.autograd.grad(chunked_attention(q, k, v, causal=causal),
                               (q, k, v), g)
    for a, b in zip(got, want):
        assert a.dtype == dt and _grad_err(a, b) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_gla_timemix_gradients_are_the_chunked_forms(hd, dt, cuda_device):
    """Kernel 6's `autograd.Function`: one call forward, and the gradients
    of the chunked form from a zero state for r, k, v, logw and u."""
    from repro_torch.kernels.gla_timemix.kernel import timemix_from_zero

    rng = np.random.default_rng(hd + 1)

    def draw(shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(cuda_device, dt)

    r, k, v = (draw((1, 128, 2, hd), hd ** -0.5).requires_grad_()
               for _ in range(3))
    logw = (-torch.exp(draw((1, 128, 2, hd), 0.5))).detach().requires_grad_()
    u = draw((2, hd)).requires_grad_()
    ins = (r, k, v, logw, u)
    g = draw((1, 128, 2, hd))
    before = cuda_lib.GLA_TIMEMIX.launches
    out = gla_timemix(*ins, chunk=32)
    got = torch.autograd.grad(out, ins, g)
    torch.cuda.synchronize()
    assert cuda_lib.GLA_TIMEMIX.launches - before == 1
    want = torch.autograd.grad(timemix_from_zero(*ins, 32), ins, g)
    for a, b in zip(got, want):
        assert a.dtype == dt and _grad_err(a, b) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-1.6b"])
def test_train_step_on_the_card_matches_the_cpu(arch, cuda_device):
    """One `make_train_step` step at m = 2 on float32 parameters: the loss
    and ``grad_norm`` on the card within `GRAD_REL` of the CPU's, the
    kernel launched twice a layer for each microbatch."""
    import dataclasses

    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    model, rules, params = _reduced_model(arch)
    model = dataclasses.replace(model, par=model.par.replace(
        num_microbatches=2))
    toks = _tokens(model, 4, 32, 11)
    step = make_train_step(model, rules, lr=1e-3).step_fn

    def run(device):
        p = _to(params, device)
        return step({"params": p, "opt": adamw_init(p)},
                    {"tokens": toks.to(device)})

    _, want = run("cpu")
    counted = (cuda_lib.FLASH_ATTENTION, cuda_lib.GLA_TIMEMIX)
    before = [k.launches for k in counted]
    new, got = run(cuda_device)
    torch.cuda.synchronize()
    rise = [k.launches - b for k, b in zip(counted, before)]
    L = model.cfg.num_layers
    assert rise == ([0, 4 * L] if model.cfg.family == "ssm" else [4 * L, 0])
    for key in ("loss", "grad_norm"):
        assert _rel_err(got[key], want[key]) <= GRAD_REL, key
    assert int(got["step"]) == 1
    assert all(bool(torch.isfinite(a).all())
               for a in tree_leaves(new["params"]))


#: the moe, hybrid and encoder-decoder archs, reduced
FAMILY_ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b", "jamba-1.5-large-398b",
                "whisper-medium")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_and_gradients_on_the_card_match_the_cpu(
        arch, cuda_device):
    """`repro_torch.bench.family_parity`, the reduced comparison (every
    attention's wq and wk times 1/4, see its docstring): a float32 train
    forward on the card launches kernel 5 once an attention layer
    (whisper's encoder layers non-causally) and its logits are within
    `MODEL_REL` of the CPU's, as are the decode logits after a prefill (a
    decode through jamba's int8 KV within the script's bar) and the loss;
    ``loss_fn``'s gradients reach every leaf, each within `GRAD_REL` of
    the CPU's, with kernel 5 launched twice an attention layer (forward
    and recompute)."""
    from repro_torch.bench.family_parity import (FAMILY_INT8_DECODE,
                                                 family_parity)

    torch.backends.cuda.matmul.allow_tf32 = False
    model, _, _ = _reduced_model(arch)
    cfg = model.cfg
    if cfg.family == "encdec":
        n_attn = cfg.encoder_layers + cfg.num_layers
    elif cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_period
    else:
        n_attn = cfg.num_layers
    e = family_parity(arch, 1, cuda_device)
    int8 = model.par.kv_cache_dtype == "int8"
    assert e["launches_forward"] == n_attn
    assert e["launches_backward"] == 2 * n_attn
    assert max(e["train"], e["loss"]) <= MODEL_REL, e
    assert e["decode"] <= (FAMILY_INT8_DECODE if int8 else MODEL_REL), e
    assert e["grad"] <= GRAD_REL, e


@pytest.mark.cuda
def test_overflowing_moe_is_bit_equal_across_card_runs(cuda_device):
    """`apply_moe` at reduced qwen3-moe width (E = 8, K = 2) with every
    token routed to experts 0 and 1, so both overflow: two runs on the card
    give the same bits, forward and gradients, and the overflowing expert
    serves cap − 1 tokens as on the CPU."""
    from repro_torch.models.moe import apply_moe, capacity

    torch.backends.cuda.matmul.allow_tf32 = False
    model, rules, params = _reduced_model("qwen3-moe-30b-a3b")
    cfg = model.cfg
    p = {k: v[0].clone() for k, v in params["layers"]["mlp"].items()}
    rng = np.random.default_rng(13)
    B, S, E = 4, 64, cfg.num_experts
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x[..., 0] = 1.0 + rng.random((B, S))
    router = 0.01 * rng.standard_normal((cfg.d_model, E))
    router[0] = [4.0, 3.0] + [-1.0 - 0.1 * e for e in range(E - 2)]
    p["router"] = torch.from_numpy(router.astype(np.float32))
    x = torch.from_numpy(x)
    upstream = torch.from_numpy(rng.standard_normal(x.shape).astype(
        np.float32))

    def run(device):
        q = {k: v.to(device).requires_grad_(True) for k, v in p.items()}
        xd = x.to(device).requires_grad_(True)
        y, aux = apply_moe(q, xd, cfg, rules)
        ((y * upstream.to(device)).sum() + aux).backward()
        return [y.detach(), aux.detach(), xd.grad] + [
            q[k].grad for k in sorted(q)]

    first, second = run(cuda_device), run(cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    served = dict(p, wo=p["wo"] * (torch.arange(E) == 0)[:, None, None])
    with torch.no_grad():
        y0 = apply_moe(_to(served, cuda_device), x.to(cuda_device), cfg,
                       rules)[0]
        y0_cpu = apply_moe(served, x, cfg, rules)[0]
    cap = capacity(B * S, cfg)
    n = int((y0.abs().amax(-1) > 0).sum())
    assert n == cap - 1 == int((y0_cpu.abs().amax(-1) > 0).sum())
    assert _rel_err(first[0], apply_moe(p, x, cfg, rules)[0].detach()) \
        <= MODEL_REL


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_under_local_map_on_a_one_card_mesh(causal,
                                                            cuda_device):
    """Kernel 5 on the sharded path (`attention._attend`: `local_map` on
    each rank's (batch, heads) block) on a 1 x 1 DeviceMesh over a one-rank
    NCCL group: one launch a call, and its plain version's output."""
    import torch.distributed as dist

    from repro_torch.comm.group import _free_port
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import Rules
    from repro_torch.models.attention import _attend, _call_self_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    kernel = next(k for k in cuda_lib.KERNELS
                  if k.source.stem == "flash_attention")
    rng = np.random.default_rng(24)
    B, S, H, KV, hd = 2, 64, 8, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, torch.bfloat16)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        rules = Rules.make(device_mesh({"data": 1, "model": 1}, "cuda"),
                           ParallelConfig())
        before = kernel.launches
        got = _attend(_call_self_attention,
                      rules.distribute(q, ("batch", "seq", "heads", None)),
                      rules.distribute(k, ("batch", "seq", "kv_heads", None)),
                      rules.distribute(v, ("batch", "seq", "kv_heads", None)),
                      causal, rules).full_tensor()
        assert kernel.launches == before + 1
    finally:
        dist.destroy_process_group()
    want = _flash_attention_plain(q, k, v, causal=causal, bq=32, bk=32)
    torch.cuda.synchronize()
    assert torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2)
