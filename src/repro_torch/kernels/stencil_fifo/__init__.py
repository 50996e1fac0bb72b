"""Jacobi-1D, the paper's motivating stencil: its PyTorch oracle and the
device-memory traffic model."""
from .ops import hbm_traffic_model
from .ref import jacobi_1d

__all__ = ["hbm_traffic_model", "jacobi_1d"]
