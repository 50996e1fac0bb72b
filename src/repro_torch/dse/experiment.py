"""Declarative experiment specs: the design space as data.

An `Experiment` names the axes the paper's trade-off is indexed by — kernel
set × tiling generator × topology × lowering overrides × problem sizes — and
expands them into `DesignPoint`s (one analysis each) grouped into
`GroupTask`s (one worker unit each: a kernel × tiling × topology triple whose
size axis is served by ONE parametric template, `core.parametric`'s
amortization).

Everything here is pure data: specs round-trip through JSON, design points
have content-addressed keys (the artifact store's filenames), and expansion
is deterministic — two processes expanding the same spec enumerate the same
points with the same keys, which is what makes resume-without-recomputation
possible at all.

Axis generators:

* ``tilings`` — ``{"kind": "rescale", "b": [1, 2, ...]}`` rescales each
  kernel's registry reference tiling (`rescale_tilings`, base 4: relative
  tile shapes and per-statement offsets are preserved), or
  ``{"kind": "explicit", "configs": {kernel: {id: {proc: tiling_doc}}}}``.
* ``topologies`` — capacity models `Analysis.plan` accepts
  (``sequential`` / ``pipeline``).
* ``sizes`` — ``{"kind": "lattice", "count": K}`` puts K points on each
  (kernel, tiling)'s probe lattice (θ + j·stride per parameter; strides are
  pure tiling arithmetic via `repro_torch.core.parametric._strides`, no analysis
  needed), so parametric evaluation stays on its proved region;
  ``{"kind": "explicit", "envs": {kernel: [{param: int}, ...]}}`` names
  concrete size points; ``{"kind": "default"}`` is each kernel's registry
  size.  Under any kind, a per-kernel ``envs`` entry pins that kernel's
  size axis explicitly — the escape hatch for kernels whose lattice
  strides grow with the tile size faster than their enumeration cost
  allows.
* ``lowering_overrides`` — a list of override maps (fnmatch channel pattern
  → lowering name from `repro_torch.runtime.lowering.LOWERINGS`); ``None`` entries
  mean "as planned".  Overrides rewrite the *plan records* of the evaluated
  report (provenance kept), modelling "what if this channel were forced onto
  the addressable buffer" without re-analysis.

``measure`` (optional) times the generated CUDA kernel for the first
``max_points`` size points of each group of the named ``kernels``:
``{"kernels": [...], "repeats": R, "max_points": P, "device": D}``, ``D``
``None`` or ``"cuda"`` for the card.  The reference's ``interpret`` key (the
TPU's interpret mode) is refused with a `SpecError`.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.tiling import Tiling, rescale_tilings

#: tile-size axis of the default experiment (the acceptance grid): b=1 is the
#: degenerate every-point-a-tile boundary, b=4 the paper's reference
DEFAULT_TILE_SIZES: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16)

SPEC_VERSION = 1


# --------------------------------------------------------------- tilings ----

def tiling_to_doc(t: Tiling) -> Dict[str, Any]:
    return {"normals": [list(n) for n in t.normals],
            "sizes": list(t.sizes), "offsets": list(t.offsets)}


def tiling_from_doc(doc: Mapping[str, Any]) -> Tiling:
    return Tiling(tuple(tuple(int(x) for x in n) for n in doc["normals"]),
                  tuple(int(b) for b in doc["sizes"]),
                  tuple(int(o) for o in doc.get("offsets", ())))


def config_to_doc(cfg: Mapping[str, Tiling]) -> Dict[str, Any]:
    return {proc: tiling_to_doc(t) for proc, t in sorted(cfg.items())}


def config_from_doc(doc: Mapping[str, Any]) -> Dict[str, Tiling]:
    return {proc: tiling_from_doc(t) for proc, t in doc.items()}


# ---------------------------------------------------------------- points ----

def _canonical(doc: Any) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def point_key(doc: Mapping[str, Any]) -> str:
    """Content address of a design point: sha256 over its canonical JSON.
    Two specs naming the same (kernel, tiling, topology, sizes, overrides,
    pow2) produce the same key — the store dedups across experiments."""
    return hashlib.sha256(_canonical(doc).encode()).hexdigest()


@dataclass(frozen=True)
class DesignPoint:
    """One cell of the design space = one analyzed report = one stored
    artifact.  ``tiling`` is the serialized per-process assignment (the
    content the key hashes, not the axis label)."""

    kernel: str
    tiling_id: str
    tiling: Mapping[str, Any]              # {proc: tiling_doc}
    topology: str
    sizes: Optional[Mapping[str, int]]     # None = kernel default sizes
    overrides: Optional[Mapping[str, str]] # fnmatch pattern -> lowering
    override_id: str = "planned"
    pow2: bool = True

    def identity(self) -> Dict[str, Any]:
        """The hashed content (axis *labels* excluded: renaming a tiling id
        must not invalidate stored results)."""
        return {"kernel": self.kernel, "tiling": dict(self.tiling),
                "topology": self.topology,
                "sizes": None if self.sizes is None else dict(self.sizes),
                "overrides": (None if self.overrides is None
                              else dict(self.overrides)),
                "pow2": self.pow2}

    @property
    def key(self) -> str:
        return point_key(self.identity())

    def as_dict(self) -> Dict[str, Any]:
        doc = self.identity()
        doc["tiling_id"] = self.tiling_id
        doc["override_id"] = self.override_id
        doc["key"] = self.key
        return doc


@dataclass(frozen=True)
class GroupTask:
    """One execution-manager unit: a (kernel, tiling, topology, override)
    cell with its whole size axis, so the worker amortizes ONE parametric
    template across every size point (`size_mode="parametric"`), falling
    back per point — loudly, with provenance — when the template does not
    close or a size is off its proved lattice."""

    task_id: str
    kernel: str
    tiling_id: str
    tiling: Mapping[str, Any]
    topology: str
    size_envs: Tuple[Optional[Mapping[str, int]], ...]
    overrides: Optional[Mapping[str, str]] = None
    override_id: str = "planned"
    size_mode: str = "parametric"          # or "concrete"
    pow2: bool = True
    measure: Optional[Mapping[str, Any]] = None   # card timing request

    def points(self) -> List[DesignPoint]:
        return [DesignPoint(self.kernel, self.tiling_id, self.tiling,
                            self.topology, env, self.overrides,
                            self.override_id, self.pow2)
                for env in self.size_envs]

    def as_dict(self) -> Dict[str, Any]:
        return {"task_id": self.task_id, "kernel": self.kernel,
                "tiling_id": self.tiling_id, "tiling": dict(self.tiling),
                "topology": self.topology,
                "size_envs": [None if e is None else dict(e)
                              for e in self.size_envs],
                "overrides": (None if self.overrides is None
                              else dict(self.overrides)),
                "override_id": self.override_id,
                "size_mode": self.size_mode, "pow2": self.pow2,
                "measure": (None if self.measure is None
                            else dict(self.measure))}

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "GroupTask":
        return cls(task_id=doc["task_id"], kernel=doc["kernel"],
                   tiling_id=doc["tiling_id"], tiling=dict(doc["tiling"]),
                   topology=doc["topology"],
                   size_envs=tuple(None if e is None else dict(e)
                                   for e in doc["size_envs"]),
                   overrides=(None if doc.get("overrides") is None
                              else dict(doc["overrides"])),
                   override_id=doc.get("override_id", "planned"),
                   size_mode=doc.get("size_mode", "parametric"),
                   pow2=bool(doc.get("pow2", True)),
                   measure=(None if doc.get("measure") is None
                            else dict(doc["measure"])))

    def restricted(self, keep_keys) -> "GroupTask":
        """The same task with the size axis restricted to the points whose
        keys are in ``keep_keys`` — how resume submits only missing work."""
        envs = tuple(p.sizes for p in self.points() if p.key in keep_keys)
        return GroupTask(self.task_id, self.kernel, self.tiling_id,
                         self.tiling, self.topology, envs, self.overrides,
                         self.override_id, self.size_mode, self.pow2,
                         self.measure)


# ------------------------------------------------------------- experiment ---

class SpecError(ValueError):
    """Malformed experiment spec (named field, actionable message)."""


@dataclass
class Experiment:
    """The declarative spec.  Construct directly, via `from_dict` (JSON), or
    via `default_experiment()` (the 15-kernel acceptance grid)."""

    name: str
    kernels: Sequence[str]
    tilings: Mapping[str, Any] = field(
        default_factory=lambda: {"kind": "rescale",
                                 "b": list(DEFAULT_TILE_SIZES)})
    topologies: Sequence[str] = ("sequential",)
    sizes: Mapping[str, Any] = field(
        default_factory=lambda: {"kind": "default"})
    lowering_overrides: Sequence[Optional[Mapping[str, str]]] = (None,)
    size_mode: Mapping[str, str] = field(
        default_factory=lambda: {"default": "parametric"})
    pow2: bool = True
    measure: Optional[Mapping[str, Any]] = None

    # ------------------------------------------------------------- identity --
    def as_dict(self) -> Dict[str, Any]:
        return {"spec_version": SPEC_VERSION, "name": self.name,
                "kernels": list(self.kernels),
                "tilings": dict(self.tilings),
                "topologies": list(self.topologies),
                "sizes": dict(self.sizes),
                "lowering_overrides": [None if o is None else dict(o)
                                       for o in self.lowering_overrides],
                "size_mode": dict(self.size_mode), "pow2": self.pow2,
                "measure": (None if self.measure is None
                            else dict(self.measure))}

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "Experiment":
        version = doc.get("spec_version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise SpecError(f"experiment spec_version {version!r} does not "
                            f"match this build's {SPEC_VERSION}")
        if not doc.get("kernels"):
            raise SpecError("spec needs a non-empty 'kernels' list")
        return cls(name=doc.get("name", "experiment"),
                   kernels=list(doc["kernels"]),
                   tilings=dict(doc.get("tilings",
                                        {"kind": "rescale",
                                         "b": list(DEFAULT_TILE_SIZES)})),
                   topologies=list(doc.get("topologies", ("sequential",))),
                   sizes=dict(doc.get("sizes", {"kind": "default"})),
                   lowering_overrides=[
                       None if o is None else dict(o)
                       for o in doc.get("lowering_overrides", [None])],
                   size_mode=dict(doc.get("size_mode",
                                          {"default": "parametric"})),
                   pow2=bool(doc.get("pow2", True)),
                   measure=(None if doc.get("measure") is None
                            else dict(doc["measure"])))

    @property
    def experiment_id(self) -> str:
        """Stable content address of the spec: the store directory name."""
        return (f"{self.name}-"
                f"{hashlib.sha256(_canonical(self.as_dict()).encode()).hexdigest()[:12]}")

    # ------------------------------------------------------------ expansion --
    def _validate(self) -> None:
        from ..runtime.lowering import LOWERINGS
        kinds = {"rescale", "explicit"}
        if self.tilings.get("kind") not in kinds:
            raise SpecError(f"tilings.kind must be one of {sorted(kinds)}, "
                            f"got {self.tilings.get('kind')!r}")
        skinds = {"lattice", "explicit", "default"}
        if self.sizes.get("kind") not in skinds:
            raise SpecError(f"sizes.kind must be one of {sorted(skinds)}, "
                            f"got {self.sizes.get('kind')!r}")
        for topo in self.topologies:
            if topo not in ("sequential", "pipeline"):
                raise SpecError(f"unknown topology {topo!r}")
        for ov in self.lowering_overrides:
            for pat, low in (ov or {}).items():
                if low not in LOWERINGS:
                    raise SpecError(
                        f"lowering override {pat!r} -> {low!r} is not in "
                        f"the lowering vocabulary {list(LOWERINGS)}")
        for k, mode in self.size_mode.items():
            if mode not in ("parametric", "concrete"):
                raise SpecError(f"size_mode[{k!r}] must be 'parametric' or "
                                f"'concrete', got {mode!r}")
        if self.measure and "interpret" in self.measure:
            raise SpecError(
                "measure.interpret selects the TPU's interpret mode, which "
                "has no meaning on the card: pass measure.device instead "
                "(None or 'cuda' times on the card; 'cpu' has every "
                "measurement refused, with a note)")

    def _tiling_axis(self, kernel: str, case) -> List[Tuple[str, Dict]]:
        spec = self.tilings
        if spec["kind"] == "rescale":
            return [(f"b{b}", config_to_doc(rescale_tilings(case.tilings,
                                                            int(b))))
                    for b in spec["b"]]
        configs = spec["configs"].get(kernel)
        if not configs:
            raise SpecError(f"tilings.configs has no entry for {kernel!r}")
        return [(tid, {proc: dict(t) for proc, t in cfg.items()})
                for tid, cfg in configs.items()]

    def _size_axis(self, kernel: str, case, cfg_doc: Mapping[str, Any]
                   ) -> List[Optional[Dict[str, int]]]:
        spec = self.sizes
        envs = (spec.get("envs") or {}).get(kernel)
        if envs:             # per-kernel explicit sizes win under any kind —
            return [dict(e) for e in envs]      # how a spec pins the size
        if spec["kind"] == "default":           # axis of kernels whose
            return [None]                       # lattice strides explode
        if spec["kind"] == "explicit":          # with the tile size
            raise SpecError(f"sizes.envs has no entry for {kernel!r}")
        # "lattice": θ + j·stride per parameter — strides are pure tiling
        # arithmetic (the Ehrhart quasi-polynomial period), cheap and
        # deterministic, so expansion needs no analysis
        from ..core.parametric import _strides
        params = tuple(case.kernel.params)
        if not params:
            return [None]
        cfg = config_from_doc(cfg_doc)
        strides = _strides(case.kernel, cfg, params)
        start = int(spec.get("start", 0))
        return [{p: int(case.kernel.params[p]) + (start + j) * strides[p]
                 for p in params}
                for j in range(int(spec.get("count", 3)))]

    def _mode(self, kernel: str) -> str:
        return self.size_mode.get(kernel,
                                  self.size_mode.get("default", "parametric"))

    def _measure_for(self, kernel: str) -> Optional[Dict[str, Any]]:
        m = self.measure
        if not m or kernel not in m.get("kernels", ()):
            return None
        return {"repeats": int(m.get("repeats", 1)),
                "max_points": int(m.get("max_points", 2)),
                "device": m.get("device")}

    def groups(self, registry_get=None) -> List[GroupTask]:
        """Expand the spec into worker units (deterministic order: kernel,
        tiling, topology, override — the size axis rides inside)."""
        if registry_get is None:      # polybench import populates the registry
            from ..core.polybench import get as registry_get
        self._validate()
        out: List[GroupTask] = []
        for kernel in self.kernels:
            case = registry_get(kernel)
            for tid, cfg_doc in self._tiling_axis(kernel, case):
                envs = tuple(self._size_axis(kernel, case, cfg_doc))
                for topo in self.topologies:
                    for oi, ov in enumerate(self.lowering_overrides):
                        oid = "planned" if ov is None else f"ov{oi}"
                        out.append(GroupTask(
                            task_id=f"{kernel}/{tid}/{topo}/{oid}",
                            kernel=kernel, tiling_id=tid, tiling=cfg_doc,
                            topology=topo, size_envs=envs,
                            overrides=ov, override_id=oid,
                            size_mode=self._mode(kernel), pow2=self.pow2,
                            measure=self._measure_for(kernel)))
        return out

    def points(self, registry_get=None) -> List[DesignPoint]:
        return [p for g in self.groups(registry_get) for p in g.points()]


def default_experiment(name: str = "polybench-full",
                       kernels: Optional[Sequence[str]] = None,
                       tile_sizes: Sequence[int] = DEFAULT_TILE_SIZES,
                       topologies: Sequence[str] = ("sequential", "pipeline"),
                       size_count: int = 3,
                       measure: Optional[Mapping[str, Any]] = None
                       ) -> Experiment:
    """The acceptance grid: all 15 PolyBench kernels × 12 tilings × 2
    topologies × 3 sizes.  The size axis is lattice-generated except where
    the economics invert: the 2d/3d stencils and doitgen run the size axis
    concretely (their probe lattices put template corner probes at
    enumeration sizes costing minutes) on explicitly pinned sizes (their
    lattice strides scale with the tile size, which their N³·T / N⁴
    enumeration cost cannot follow).  symm, cholesky and lu are pinned for
    the same reason with a different mechanism: their templates rarely
    close (symm's symmetric access pieces, the triangular nests' escalated
    quasi-period lattice), so at large tile sizes the worker would spend
    minutes of corner probes per group only to fall back concrete anyway.
    All per-kernel overrides are recorded in the spec — nothing is
    silently special-cased at run time."""
    if kernels is None:
        from ..core.polybench import kernel_names
        kernels = kernel_names()
    return Experiment(
        name=name, kernels=list(kernels),
        tilings={"kind": "rescale", "b": list(tile_sizes)},
        topologies=list(topologies),
        sizes={"kind": "lattice", "count": size_count,
               "envs": {
                   "jacobi-2d": [{"N": 10, "T": 4}, {"N": 14, "T": 6},
                                 {"N": 18, "T": 8}],
                   "seidel-2d": [{"N": 10, "T": 4}, {"N": 14, "T": 6},
                                 {"N": 18, "T": 8}],
                   "heat-3d": [{"N": 8, "T": 4}, {"N": 10, "T": 4},
                               {"N": 12, "T": 6}],
                   "doitgen": [{"N": 8}, {"N": 10}, {"N": 12}],
                   "symm": [{"N": 12}, {"N": 16}, {"N": 20}],
                   "cholesky": [{"N": 12}, {"N": 16}, {"N": 20}],
                   "lu": [{"N": 12}, {"N": 16}, {"N": 20}]}},
        size_mode={"default": "parametric",
                   "jacobi-2d": "concrete", "seidel-2d": "concrete",
                   "heat-3d": "concrete", "doitgen": "concrete",
                   "symm": "concrete", "cholesky": "concrete",
                   "lu": "concrete"},
        measure=measure)
