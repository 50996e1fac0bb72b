"""The reference and its frozen work counts: the reference against the
port's plain path on the CPU at small sizes, the counts against values
worked out by hand, and the control's lower precisions failing the limit
that the program's plain path meets."""
from __future__ import annotations

import json

import pytest
import torch

from portbench.lib.compare import CONTROLS, max_rel_err, sweeps, tf32
from portbench.lib.plugins import load_module

from .conftest import ROOT

SMALL = {"jacobi-2d": (16, 16), "heat-3d": (8, 8, 8)}
T = 16
#: the control's shapes: the cell's sweeps at a size the CPU holds
CONTROL = {"jacobi-2d": (32, 32), "heat-3d": (16, 16, 16)}


def reference(program: str):
    return load_module(ROOT / "portbench" / "reference", program)


def xl(program: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" /
                       f"{program}-xl.json").read_text())


def limit(program: str) -> float:
    return xl(program)["limits"]["max_rel_err"]


def plain_port(program: str, x: torch.Tensor, mode: str, T: int = T
               ) -> torch.Tensor:
    """The port's own path on the CPU: its plain versions of the kernels,
    through the `CompiledStencil` that ``compile`` returns."""
    import repro_torch.core.polybench  # noqa: F401
    from repro_torch.core import analyze
    from repro_torch.core.registry import get

    a = analyze(get(program)).classify().fifoize().size().plan()
    c = a.compile(backend="cuda", device="cpu", mode=mode)
    if mode == "addressable":
        return c(x, T, 8)
    y = x
    for _ in range(T // 8):
        y = c(y, 8, 8)
    return y


@pytest.mark.parametrize("mode", ["fifo-ring", "addressable"])
@pytest.mark.parametrize("program", sorted(SMALL))
def test_reference_against_the_port(program, mode):
    g = torch.Generator().manual_seed(11)
    x = torch.rand(SMALL[program], generator=g)
    ref = reference(program)
    want32 = sweeps(ref.sweep, x, T)
    want64 = sweeps(ref.sweep, x.double(), T)
    got = plain_port(program, x, mode)
    assert max_rel_err(got, want32) <= 1e-6
    assert max_rel_err(got, want64) <= limit(program)
    from repro_torch.runtime.cuda_codegen import STENCIL_PROGRAMS
    assert max_rel_err(STENCIL_PROGRAMS[program].ref(x, T), want32) <= 1e-6


def test_one_sweep_by_hand():
    a = torch.zeros(3, 3, dtype=torch.float64)
    a[1, 1] = 5.0
    out = reference("jacobi-2d").sweep(a)
    assert out[1, 1] == 1.0 and out[0, 1] == 1.0 and out[0, 0] == 0.0
    b = torch.zeros(3, 3, 3, dtype=torch.float64)
    b[1, 1, 1] = 8.0
    out = reference("heat-3d").sweep(b)
    # the centre loses 6 x 0.125 x 2 x 8 / 2 = 6 of 8; each face neighbour
    # gains 0.125 x 8 = 1
    assert out[1, 1, 1] == 2.0 and out[0, 1, 1] == 1.0 and out[0, 0, 0] == 0


def test_work_counts_by_hand():
    j, h = reference("jacobi-2d"), reference("heat-3d")
    n2, n3 = 2800 * 2800, 200 ** 3
    # a ring launch: 8 sweeps; an addressable launch: 1; a job: 2000
    assert j.work((2800, 2800), 8) == {"flops": 313_600_000,
                                       "bytes": 62_720_000}
    assert j.work((2800, 2800), 1) == {"flops": 39_200_000,
                                       "bytes": 62_720_000}
    assert j.work((2800, 2800), 2000) == {"flops": 78_400_000_000,
                                          "bytes": 8 * n2}
    assert h.work((200, 200, 200), 8) == {"flops": 960_000_000,
                                          "bytes": 64_000_000}
    assert h.work((200, 200, 200), 1) == {"flops": 120_000_000,
                                          "bytes": 64_000_000}
    assert h.work((200, 200, 200), 2000) == {"flops": 240_000_000_000,
                                             "bytes": 8 * n3}


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      1.0 + 2 ** -12, -3.0000002])
    assert tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 1.0, -3.0]


@pytest.mark.parametrize("program", sorted(CONTROL))
def test_control_fails_the_limit(program):
    """The reference in the program's place at TF32 and at bfloat16 fails
    the limit that the port's plain path meets, on three seeds, at the
    cell's sweeps over a small array (the control's error grows with the
    sweeps: at 16 it stays under the limit)."""
    ref = reference(program)
    n = xl(program)["sweeps"]
    for seed in (1, 2, 3):
        x = torch.rand(CONTROL[program],
                       generator=torch.Generator().manual_seed(seed))
        want = sweeps(ref.sweep, x.double(), n)
        assert max_rel_err(plain_port(program, x, "fifo-ring", n),
                           want) <= limit(program)
        for level in CONTROLS.values():
            assert max_rel_err(sweeps(ref.sweep, x, n, level),
                               want) > limit(program)
