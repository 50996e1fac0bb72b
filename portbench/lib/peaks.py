"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit; a card set below it runs
slower under load, so a run records the card's power limit beside its
numbers).  A frozen copy of the port's `repro_torch/device.py` values."""

HBM_BW = 3.35e12                   # B/s, device memory
PEAK_FLOPS_FP32 = 67e12            # FLOP/s, float32 outside the tensor cores


def roofline_seconds(flops: float, bytes_moved: float) -> float:
    """The least time the card could take for ``flops`` float32 operations
    on the CUDA cores that must move ``bytes_moved`` through device memory:
    the larger of the two times."""
    return max(flops / PEAK_FLOPS_FP32, bytes_moved / HBM_BW)
