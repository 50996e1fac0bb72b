"""The DSE service: orchestration + resumable persistence + frontiers.

`DSEService` drives one `Experiment` to completion against an
`ArtifactStore`:

1. expand the spec into `GroupTask`s (deterministic order, content-addressed
   point keys);
2. **store-first**: restrict every group to the points the store does not
   already hold (this is resume — an interrupted sweep rerun with the same
   spec recomputes nothing, which the accounting in the returned summary
   proves: ``from_store`` vs ``computed``);
3. submit the restricted groups to an `ExecutionManager` and persist every
   point result the moment it arrives (atomic write per point — a kill
   between two points loses at most the in-flight group);
4. save the polyhedron verdict layer so the *analysis-level* cache also
   survives the process.

``max_points`` is a graceful budget: the service stops submitting once that
many new points are in flight (completed groups are still persisted), which
is both the CI smoke's interrupt story and a way to chip at a large grid in
bounded slices.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Union

from .experiment import Experiment
from .managers import ExecutionManager, make_manager
from .pareto import frontier_by_kernel, frontier_summary
from .store import ArtifactStore

SCHEMA = "repro-dse-run-v1"


class DSEService:
    def __init__(self, experiment: Experiment,
                 store: Optional[ArtifactStore] = None,
                 manager: Union[str, ExecutionManager] = "inline",
                 manager_kwargs: Optional[Mapping[str, Any]] = None):
        self.experiment = experiment
        self.store = store or ArtifactStore()
        self._manager = manager
        self._manager_kwargs = dict(manager_kwargs or {})

    # ----------------------------------------------------------------- run --
    def run(self, max_points: Optional[int] = None,
            progress=None) -> Dict[str, Any]:
        """Run (or resume — same call) the experiment.  Returns the
        accounting summary; results live in the store."""
        t0 = time.perf_counter()
        eid = self.store.init_experiment(self.experiment)
        poly_loaded = self.store.load_poly_layer()
        groups = self.experiment.groups()
        total = sum(len(g.size_envs) for g in groups)
        from_store = submitted = 0
        stopped_early = False

        manager = self._manager if isinstance(self._manager,
                                              ExecutionManager) \
            else make_manager(self._manager, **self._manager_kwargs)
        computed = errors = 0
        try:
            for group in groups:
                missing = [p.key for p in group.points()
                           if not self.store.has_point(eid, p.key)]
                from_store += len(group.size_envs) - len(missing)
                if not missing:
                    continue
                if max_points is not None:
                    room = max_points - submitted
                    if room <= 0:
                        stopped_early = True
                        break
                    if len(missing) > room:
                        missing = missing[:room]
                        stopped_early = True
                manager.submit(group.task_id, group.restricted(
                    set(missing)).as_dict())
                submitted += len(missing)
            for task_id, results in manager.drain():
                for doc in results:
                    key = doc.get("key")
                    if key:
                        self.store.put_point(eid, key, doc)
                    computed += 1
                    if doc.get("error"):
                        errors += 1
                if progress is not None:
                    progress(task_id, results)
        finally:
            if not isinstance(self._manager, ExecutionManager):
                manager.close()
            poly_saved = self.store.save_poly_layer()
        return {"schema": SCHEMA, "experiment_id": eid,
                "groups": len(groups), "points_total": total,
                "from_store": from_store, "submitted": submitted,
                "computed": computed, "errors": errors,
                "stopped_early": stopped_early,
                "pending": total - from_store - computed,
                "poly_layer": {"loaded": poly_loaded, "saved": poly_saved},
                "store": dict(self.store.stats),
                "seconds": round(time.perf_counter() - t0, 3)}

    # ------------------------------------------------------------ frontier --
    def frontier(self, cost_key: str = "predicted_s") -> Dict[str, Any]:
        """Per-kernel Pareto frontiers over every completed point in the
        store; persisted as the experiment's ``frontier.json``.  Purely a
        function of the stored points — an interrupted-then-resumed run and
        an uninterrupted one produce byte-identical frontier files."""
        eid = self.store.init_experiment(self.experiment)
        points = list(self.store.iter_points(eid))
        kernels = frontier_by_kernel(points, cost_key)
        doc = {"schema": "repro-dse-frontier-v1", "experiment_id": eid,
               "experiment": self.experiment.as_dict(),
               "points": len(points),
               "errors": sum(1 for p in points if p.get("error")),
               "kernels": kernels}
        self.store.put_frontier(eid, doc)
        return doc

    def frontier_lines(self, doc: Optional[Mapping[str, Any]] = None
                       ) -> List[str]:
        doc = doc or self.frontier()
        return frontier_summary(doc["kernels"])

    # -------------------------------------------------------------- status --
    def status(self) -> Dict[str, Any]:
        return self.store.status(self.experiment)
