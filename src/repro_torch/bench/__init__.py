"""Benchmarks of the port, timed on the card with CUDA events."""
from __future__ import annotations

import statistics


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event times of one call of ``fn``, in ms,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
