"""Content-addressed on-disk artifact store: every finished design point is
durable the moment it completes, so an interrupted sweep resumes without
recomputing anything.

Layout (under one root, default ``.cache/dse`` or ``$REPRO_DSE_STORE``)::

    <root>/experiments/<experiment_id>/experiment.json   the spec, verbatim
    <root>/experiments/<experiment_id>/points/<key>.json one completed point
    <root>/experiments/<experiment_id>/frontier.json     last computed frontier
    <root>/poly/verdicts.pkl                             layered polyhedron
                                                         verdict store

Point files are named by the design point's content hash (`DesignPoint.key`)
and written atomically (tmp + rename, the `save_polyhedron_cache` idiom), so
a killed writer never leaves a half artifact — a file either parses or does
not exist.  The polyhedron layer reuses the core's versioned persistent store
(`save/load_polyhedron_cache`): warm verdicts survive across runs AND across
experiments, which is what makes resumed probe/template work cheap even for
the design points that do have to be recomputed.

The store counts its own traffic (``hits`` = points served from disk,
``writes`` = points persisted this run) — the accounting the resume tests
and `repro_torch.dse status` read.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional

from ..core.polyhedron import (load_polyhedron_cache, peek_polyhedron_cache,
                               save_polyhedron_cache)

ENV_STORE = "REPRO_DSE_STORE"
DEFAULT_ROOT = ".cache/dse"


def store_root(root: Optional[str] = None) -> Path:
    return Path(root or os.environ.get(ENV_STORE, DEFAULT_ROOT))


def _atomic_write(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class StoreConflict(RuntimeError):
    """An experiment id already holds a *different* spec — refusing to mix
    artifacts from two definitions of the design space."""


class ArtifactStore:
    """One experiment's durable results + the shared verdict layer."""

    def __init__(self, root: Optional[str] = None):
        self.root = store_root(root)
        self.stats = {"hits": 0, "misses": 0, "writes": 0}

    # ------------------------------------------------------------ layout ----
    def experiment_dir(self, experiment_id: str) -> Path:
        return self.root / "experiments" / experiment_id

    def points_dir(self, experiment_id: str) -> Path:
        return self.experiment_dir(experiment_id) / "points"

    def poly_path(self) -> Path:
        return self.root / "poly" / "verdicts.pkl"

    # -------------------------------------------------------- experiments ---
    def init_experiment(self, experiment) -> str:
        """Register the spec; refuses a colliding id with different content
        (content-addressed ids make that a hash collision or a hand-edit)."""
        eid = experiment.experiment_id
        spec_path = self.experiment_dir(eid) / "experiment.json"
        doc = experiment.as_dict()
        if spec_path.exists():
            if json.loads(spec_path.read_text()) != doc:
                raise StoreConflict(
                    f"{spec_path} holds a different spec for id {eid}")
        else:
            _atomic_write(spec_path, json.dumps(doc, indent=1,
                                                sort_keys=True))
        return eid

    def load_experiment(self, experiment_id: str):
        from .experiment import Experiment
        spec_path = self.experiment_dir(experiment_id) / "experiment.json"
        if not spec_path.exists():
            raise FileNotFoundError(
                f"no experiment {experiment_id!r} under {self.root} "
                f"(have: {self.experiment_ids()})")
        return Experiment.from_dict(json.loads(spec_path.read_text()))

    def experiment_ids(self) -> List[str]:
        base = self.root / "experiments"
        if not base.is_dir():
            return []
        return sorted(p.name for p in base.iterdir()
                      if (p / "experiment.json").exists())

    # ------------------------------------------------------------- points ---
    def has_point(self, experiment_id: str, key: str) -> bool:
        return (self.points_dir(experiment_id) / f"{key}.json").exists()

    def get_point(self, experiment_id: str, key: str
                  ) -> Optional[Dict[str, Any]]:
        path = self.points_dir(experiment_id) / f"{key}.json"
        try:
            doc = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        return doc

    def put_point(self, experiment_id: str, key: str,
                  doc: Mapping[str, Any]) -> None:
        _atomic_write(self.points_dir(experiment_id) / f"{key}.json",
                      json.dumps(doc, sort_keys=True))
        self.stats["writes"] += 1

    def point_keys(self, experiment_id: str) -> List[str]:
        d = self.points_dir(experiment_id)
        if not d.is_dir():
            return []
        return sorted(p.stem for p in d.glob("*.json"))

    def iter_points(self, experiment_id: str) -> Iterator[Dict[str, Any]]:
        for key in self.point_keys(experiment_id):
            doc = self.get_point(experiment_id, key)
            if doc is not None:
                yield doc

    # ----------------------------------------------------------- frontier ---
    def put_frontier(self, experiment_id: str, doc: Mapping[str, Any]) -> None:
        _atomic_write(self.experiment_dir(experiment_id) / "frontier.json",
                      json.dumps(doc, indent=1, sort_keys=True))

    def get_frontier(self, experiment_id: str) -> Optional[Dict[str, Any]]:
        path = self.experiment_dir(experiment_id) / "frontier.json"
        if not path.exists():
            return None
        return json.loads(path.read_text())

    # --------------------------------------------------------- poly layer ---
    def load_poly_layer(self) -> int:
        """Warm the in-memory polyhedron verdict caches from the store."""
        return load_polyhedron_cache(str(self.poly_path()))

    def save_poly_layer(self) -> int:
        return save_polyhedron_cache(str(self.poly_path()))

    def poly_info(self) -> Optional[Dict[str, int]]:
        return peek_polyhedron_cache(str(self.poly_path()))

    # ------------------------------------------------------------- status ---
    def status(self, experiment=None) -> Dict[str, Any]:
        """Store-wide (or one experiment's) progress: how many of the spec's
        points are done, how many remain, what the verdict layer holds."""
        out: Dict[str, Any] = {"root": str(self.root),
                               "poly": self.poly_info(),
                               "experiments": {}}
        ids = ([experiment.experiment_id] if experiment is not None
               else self.experiment_ids())
        for eid in ids:
            try:
                exp = experiment if experiment is not None \
                    else self.load_experiment(eid)
                total = len(exp.points())
            except Exception as e:               # spec may predate this build
                out["experiments"][eid] = {"error": f"{type(e).__name__}: {e}"}
                continue
            done = len(self.point_keys(eid))
            out["experiments"][eid] = {
                "name": exp.name, "points": total, "done": done,
                "pending": max(0, total - done),
                "frontier": (self.experiment_dir(eid)
                             / "frontier.json").exists()}
        return out
