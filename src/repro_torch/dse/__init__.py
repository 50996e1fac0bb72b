"""Design-space exploration over the paper's communication trade.

The analysis engine answers one question per configuration — "which
channels does this tiling leave FIFO, and what does the network cost?" —
and the interesting object is the *map* of those answers over tiling ×
topology × lowering × problem size.  This package is the service that
builds the map:

* `experiment`  — declarative `Experiment` specs; axis generators expand
  deterministically into content-addressed `DesignPoint`s grouped into
  `GroupTask` worker units (the size axis served by one `core.parametric`
  template per group);
* `managers`    — pluggable `ExecutionManager`s: `inline`, process `pool`
  (polyhedron-cache sharing both ways), `subprocess` behind a slurm-style
  submit/poll batch interface (+ the `SlurmManager` cluster stub);
* `store`       — resumable on-disk `ArtifactStore`: every completed point
  persisted atomically as it finishes, layered over the versioned
  polyhedron verdict store, so an interrupted sweep resumes with zero
  recomputation;
* `worker`      — evaluates one group: template/concrete analysis,
  lowering-override rewriting, frontier metrics, optional measured time of
  the generated CUDA kernel on the card;
* `pareto`      — per-kernel Pareto frontiers over (fifo_fraction,
  total_slots, cost) with dominated-point provenance;
* `service`     — `DSEService.run/frontier/status`, also the
  ``python -m repro_torch.dse`` CLI.
"""
from .experiment import (DesignPoint, Experiment, GroupTask, SpecError,
                         default_experiment, point_key)
from .managers import (BatchManager, ExecutionManager, InlineManager,
                       PoolManager, SlurmManager, SubprocessManager,
                       make_manager)
from .pareto import (dominates, frontier_by_kernel, objective_vector,
                     pareto_front)
from .service import DSEService
from .store import ArtifactStore, StoreConflict
from .worker import run_group

__all__ = [
    "ArtifactStore", "BatchManager", "DSEService", "DesignPoint",
    "Experiment", "ExecutionManager", "GroupTask", "InlineManager",
    "PoolManager", "SlurmManager", "SpecError", "StoreConflict",
    "SubprocessManager", "default_experiment", "dominates",
    "frontier_by_kernel", "make_manager", "objective_vector", "pareto_front",
    "point_key", "run_group",
]
