"""The plain reference of the port's heat-3d program, and its frozen work
counts.

One sweep updates every cell of a 3-D array with the 7-point heat step,
zero outside the array:
``a <- a + 0.125 (d2_i a) + 0.125 (d2_j a) + 0.125 (d2_k a)``, each ``d2``
the central second difference ``a[-1] - 2 a + a[+1]`` along one axis.  Pads
and slices only, in the dtype of its input.  Written from the update's
definition; it shares no code with the port.
"""
import torch.nn.functional as F

#: float32 operations a cell takes in one sweep: per axis two subtractions
#: or additions, one product by 2 and one by 0.125, then three adds
FLOPS_PER_CELL = 15


def sweep(a):
    p = F.pad(a, (1, 1, 1, 1, 1, 1))
    c = p[1:-1, 1:-1, 1:-1]
    return (c
            + 0.125 * (p[:-2, 1:-1, 1:-1] - 2.0 * c + p[2:, 1:-1, 1:-1])
            + 0.125 * (p[1:-1, :-2, 1:-1] - 2.0 * c + p[1:-1, 2:, 1:-1])
            + 0.125 * (p[1:-1, 1:-1, :-2] - 2.0 * c + p[1:-1, 1:-1, 2:]))


def work(shape, sweeps: int, itemsize: int = 4) -> dict:
    """The least work of ``sweeps`` sweeps over an array of ``shape``:
    every sweep's operations, and the input read once and the output
    written once."""
    cells = 1
    for n in shape:
        cells *= int(n)
    return {"flops": FLOPS_PER_CELL * cells * sweeps,
            "bytes": 2 * cells * itemsize}
