"""The device-memory traffic model of the FIFO-streamed stencil.

A copy of `repro.kernels.stencil_fifo.ops.hbm_traffic_model`; the
hand-written Fig. 3 kernel's wrappers (``jacobi_fifo_op``,
``jacobi_naive_op``) come with that kernel's port."""
from __future__ import annotations

from typing import Dict


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
