"""The plain reference of the port's jacobi-2d program, and its frozen work
counts.

One sweep updates every cell of a 2-D array with the 5-point average of
itself and its four neighbours, zero outside the array:
``a[i,j] <- (a[i,j] + a[i,j-1] + a[i,j+1] + a[i-1,j] + a[i+1,j]) / 5``.
Pads and slices only (a convolution may run in TF32 on the card), in the
dtype of its input.  Written from the update's definition; it shares no
code with the port.
"""
import torch.nn.functional as F

#: float32 operations a cell takes in one sweep: four adds, one divide
FLOPS_PER_CELL = 5


def sweep(a):
    p = F.pad(a, (1, 1, 1, 1))
    return (p[1:-1, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            + p[:-2, 1:-1] + p[2:, 1:-1]) / 5.0


def work(shape, sweeps: int, itemsize: int = 4) -> dict:
    """The least work of ``sweeps`` sweeps over an array of ``shape``:
    every sweep's operations, and the input read once and the output
    written once."""
    cells = 1
    for n in shape:
        cells *= int(n)
    return {"flops": FLOPS_PER_CELL * cells * sweeps,
            "bytes": 2 * cells * itemsize}
