"""Executable channel runtime: the lowering IR, its backends, and the
operational validation stage.

    lowering     — lowering vocabulary, THE verdict→lowering table, registry
    simulator    — trace-driven reference backend (vectorized replay)
    validate     — `Analysis.validate()`: every verdict executed, both ways
    cuda_backend / cuda_codegen — hand-written CUDA ring kernels: trace
                   replay through a real ring + the whole-PPN compiler
                   behind `Analysis.compile(backend="cuda")` (lazy; imports
                   torch, builds the kernels at first launch)
    torch_backend — the pipeline ring's per-tick collectives on a stage
                   group (`comm.group`), registered as ``"torch"`` (lazy)
    selftimed    — dataflow-driven execution engine on the host: bounded
                   back-pressured channels, deadlock detection, stall
                   observability (`Analysis.validate(mode="selftimed")`;
                   loaded lazily as the ``"selftimed"`` registry backend)
    resilience   — fault injection + self-healing channel guards over the
                   engine's hook seam: seeded `FaultPlan`s, sequence-tag /
                   checksum / watchdog guards, bounded replay recovery,
                   FIFO→reorder-buffer hot-swap degradation
                   (`Analysis.validate(mode="faults")`; its wire faults
                   replay through kernel 3 on the ``"cuda"`` backend;
                   loaded lazily)
"""
from .lowering import (BROADCAST_REGISTER, CHUNK_SPLIT, DEPTH_SPLIT,
                       FIFO_STREAM, LOWERINGS, PATTERN_LOWERING,
                       REORDER_BUFFER, Backend, BackendUnavailable,
                       ChannelLowering, available_backends, backend,
                       backend_names, is_cheap, is_stream,
                       lowering_for_pattern, register_backend,
                       split_lowering)
from .simulator import (ChannelTrace, OrderViolation, SimulationError,
                        channel_late_edges, simulate_channel, trace_channel)
from .validate import (ChannelValidation, ValidationError, ValidationReport,
                       validate_analysis)

__all__ = [
    "BROADCAST_REGISTER", "Backend", "BackendUnavailable", "CHUNK_SPLIT",
    "ChannelLowering", "ChannelTrace", "ChannelValidation", "DEPTH_SPLIT",
    "FIFO_STREAM", "LOWERINGS", "OrderViolation", "PATTERN_LOWERING",
    "REORDER_BUFFER", "SimulationError", "ValidationError",
    "ValidationReport", "available_backends", "backend", "backend_names",
    "channel_late_edges", "is_cheap", "is_stream", "lowering_for_pattern",
    "register_backend", "simulate_channel", "split_lowering",
    "trace_channel", "validate_analysis",
]
