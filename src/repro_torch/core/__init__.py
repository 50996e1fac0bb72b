"""The paper's contribution: PPN channel classification + FIFO recovery.

A copy of the reference package's jax-free analysis layers under the same
names (the port imports nothing of it), parametric analysis and tile sweeps
included.

Public API:
    affine / polyhedron / relation  — Presburger-lite machinery
    dataflow                        — kernel IR + exact direct dependences
    ppn                             — polyhedral process networks
    patterns                        — FIFO / in-order / out-of-order classifier
    split                           — SPLIT + FIFOIZE (paper Fig. 2)
    sizing                          — channel capacity + pow2 heuristic
    registry                        — frontend-agnostic kernel registry
    polybench                       — the paper's 15-kernel benchmark suite
                                      (authored via `repro_torch.lang`, the
                                      declarative builder frontend)
"""
from .affine import Constraint, LinExpr, ceil_div, eq, floor_div, ge, gt, le, lt, v
from .analysis import (SCHEMA_VERSION, Analysis, AnalysisContext,
                       AnalysisReport, ChannelPlan, analyze)
from .dataflow import Access, DepEdges, Kernel, Statement, direct_dependences
from .deprecation import reset_deprecation_warnings
from .parametric import (ParametricAnalysis, ParametricFallbackWarning,
                         SizePoly, symbolic)
from .patterns import (ChannelClassifier, Pattern, ProcSpace, classify_channel,
                       classify_channels, classify_edges, classify_symbolic,
                       in_order_symbolic, unicity_symbolic)
from .polyhedron import (FMBlowup, Polyhedron, clear_polyhedron_cache,
                         export_polyhedron_cache, load_polyhedron_cache,
                         merge_polyhedron_cache, peek_polyhedron_cache,
                         polyhedron_cache_pin, polyhedron_cache_stats,
                         save_polyhedron_cache)
from .ppn import PPN, Channel, DomainIndex, Process
from .registry import resolve_case
from .relation import Relation
from .schedule import (AffineSchedule, PROLOGUE_C0, boundary_schedule,
                       epilogue_c0)
from .sizing import (SizingContext, channel_capacity, pow2_size,
                     size_channels, tick_capacity)
from .split import (FifoizeReport, NotApplicable, fifoize, fifoize_relation,
                    split_by_tile_pair, split_channel, split_covers,
                    split_relation)
from .sweep import (SweepJob, report_payload, run_job, sweep, sweep_parallel)
from .tiling import (Tiling, rectangular, rescale_tilings, unit_tilings)

__all__ = [
    "Access", "AffineSchedule", "Analysis", "AnalysisContext",
    "AnalysisReport", "Channel", "ChannelClassifier", "ChannelPlan",
    "Constraint", "DepEdges", "DomainIndex", "FMBlowup", "FifoizeReport",
    "Kernel", "LinExpr", "NotApplicable", "PPN", "ParametricAnalysis",
    "ParametricFallbackWarning", "Pattern", "Polyhedron", "ProcSpace",
    "Process", "Relation", "SCHEMA_VERSION", "SizePoly", "SizingContext",
    "Statement",
    "Tiling", "analyze", "SweepJob", "PROLOGUE_C0", "boundary_schedule",
    "ceil_div", "channel_capacity", "classify_channel",
    "classify_channels", "classify_edges", "classify_symbolic",
    "clear_polyhedron_cache", "direct_dependences", "eq",
    "export_polyhedron_cache", "fifoize", "fifoize_relation", "floor_div",
    "ge", "gt", "in_order_symbolic", "le", "load_polyhedron_cache", "lt",
    "epilogue_c0", "merge_polyhedron_cache", "peek_polyhedron_cache",
    "polyhedron_cache_pin",
    "polyhedron_cache_stats",
    "pow2_size", "rectangular", "report_payload", "rescale_tilings",
    "resolve_case",
    "reset_deprecation_warnings", "run_job", "save_polyhedron_cache",
    "size_channels", "split_by_tile_pair", "split_channel", "split_covers",
    "split_relation", "sweep", "sweep_parallel", "symbolic",
    "tick_capacity", "unicity_symbolic", "unit_tilings", "v",
]
