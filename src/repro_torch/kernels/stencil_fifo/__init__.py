"""Jacobi-1D, the paper's motivating stencil: the hand-written Fig. 3
kernel (`jacobi_fifo`, kernel 4), its wrappers, its PyTorch oracle and the
device-memory traffic model."""
from .kernel import jacobi_fifo
from .ops import hbm_traffic_model, jacobi_fifo_op, jacobi_naive_op
from .ref import jacobi_1d

__all__ = ["hbm_traffic_model", "jacobi_1d", "jacobi_fifo", "jacobi_fifo_op",
           "jacobi_naive_op"]
