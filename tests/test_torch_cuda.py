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
from repro_torch.core.schedule import AffineSchedule  # noqa: E402
from repro_torch.runtime import trace_channel  # noqa: E402
from repro_torch.runtime.cuda_backend import (  # noqa: E402
    _build_events, _replay_plain, replay_events)
from repro_torch.runtime.cuda_codegen import (  # noqa: E402
    STENCIL_PROGRAMS, _addressable_plain, _ring_plain, addressable_step,
    ring_stencil)

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
