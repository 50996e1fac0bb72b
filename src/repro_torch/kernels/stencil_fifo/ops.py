"""Public wrappers of the FIFO-streamed stencil: the hand-written Fig. 3
kernel (`jacobi_fifo_op`), the naive path that round-trips the array
through device memory every time step (`jacobi_naive_op`, the oracle and
the measured baseline), and the device-memory traffic model the benchmark
reports beside them.

The port of `repro.kernels.stencil_fifo.ops`.  PyTorch runs eagerly, so
where the reference jits its wrappers the port names the functions
themselves: `jacobi_fifo_op` is `jacobi_fifo` (the kernel on a CUDA
tensor, its plain version on a CPU one) and `jacobi_naive_op` is
`ref.jacobi_1d`."""
from __future__ import annotations

from typing import Dict

from .kernel import jacobi_fifo
from .ref import jacobi_1d


jacobi_fifo_op = jacobi_fifo
jacobi_naive_op = jacobi_1d


def hbm_traffic_model(n: int, steps: int, dtype_bytes: int = 4) -> Dict[str, float]:
    """Bytes moved to/from device memory (the roofline 'memory' term
    numerator).

    naive: every timestep reads and writes the array (the addressable-buffer
    pattern); fifo: one read + one write total — cross-tile dependences live
    in the on-chip rings (paper's channel split, sizes (T+1)·2 per depth)."""
    naive = steps * 2 * n * dtype_bytes
    fifo = 2 * n * dtype_bytes
    return {"naive_bytes": float(naive), "fifo_bytes": float(fifo),
            "reduction": naive / fifo}
