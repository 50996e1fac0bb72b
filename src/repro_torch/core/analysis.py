"""Unified staged analysis driver — the paper's flow as one fluent API.

    from repro_torch.core import analyze

    report = (analyze(case.kernel, tilings=case.tilings)
              .classify()          # per-channel pattern (batched ranks)
              .fifoize()           # SPLIT + FIFOIZE (paper Fig. 2)
              .size(pow2=True)     # buffer capacities (paper §4)
              .plan()              # lowering IR per channel (runtime registry)
              .validate()          # operational replay of every verdict
              .report())           # JSON-serializable artifact

Each stage returns a NEW immutable `Analysis`; all of them share one
`AnalysisContext` carrying the memoized per-process machinery — the
`ChannelClassifier` (local timestamps + lex ranks), the `SizingContext`
(global timestamps + ranks) and the dataflow oracle's output (the PPN built
once by `analyze`).  No stage ever rebuilds what a previous stage computed:
the rewritten PPN after FIFOIZE shares `Process` objects with the original,
so the same classifier/sizing caches serve both sides of every
before/after comparison.  `report()` emits the `AnalysisReport` that the
benchmarks (`table1_storage`, `table2_fifo`), the quickstart and CI consume.

The old free functions (`classify_channel`, `classify_channels`,
`size_channels`, `channel_capacity`, `fifoize`) remain as deprecated
delegating shims — byte-identical results, just without stage sharing.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

from .dataflow import Kernel
from .patterns import ChannelClassifier, Pattern, _classify_channels
from .polyhedron import polyhedron_cache_stats
from .ppn import PPN, Channel
from .sizing import (SizingContext, _channel_capacity, _size_channels,
                     pow2_size, tick_capacity)
from .split import (FifoizeReport, NotApplicable, _fifoize, split_by_tile_pair,
                    split_channel)
from .tiling import Tiling


class AnalysisContext:
    """Mutable memo shared by every `Analysis` in a pipeline: the classifier
    and sizing context are built lazily, exactly once, and threaded through
    all stages.  They key their per-process caches on `Process` identity, so
    the FIFOIZE-rewritten PPN (which shares processes) reuses them as-is."""

    def __init__(self) -> None:
        self._classifier: Optional[ChannelClassifier] = None
        self._sizing: Optional[SizingContext] = None
        # when the parametric engine probes a concrete size it sets this to a
        # dict; the size/plan stages then record raw (pre-pow2) capacities
        # under "size_raw" / "plan_raw" without changing their outputs
        self.capture: Optional[Dict[str, Any]] = None
        self.counters: Dict[str, int] = {
            "classifier_builds": 0, "sizing_builds": 0,
            "classify_stages": 0, "fifoize_stages": 0,
            "size_stages": 0, "plan_stages": 0, "validate_stages": 0,
            "selftimed_stages": 0, "faults_stages": 0, "retiles": 0,
        }

    def classifier(self, ppn: PPN) -> ChannelClassifier:
        if self._classifier is None:
            self._classifier = ChannelClassifier(ppn)
            self.counters["classifier_builds"] += 1
        self._classifier.ppn = ppn
        return self._classifier

    def sizing(self, ppn: PPN) -> SizingContext:
        if self._sizing is None:
            self._sizing = SizingContext(ppn)
            self.counters["sizing_builds"] += 1
        self._sizing.ppn = ppn
        return self._sizing


@dataclass
class ChannelPlan:
    """One channel's backend-neutral lowering record — the unit of the
    lowering IR.  ``lowering`` is drawn from the vocabulary in
    `repro_torch.runtime.lowering` (the single verdict→lowering table lives
    there); both backends — the trace-driven reference simulator and the
    JAX collectives — consume these records through the registry.
    """

    name: str
    pattern_before: str
    split: bool
    parts: List[Tuple[int, str, int]]      # (depth, pattern, pow2 buffer size)
    lowering: str
    buffer_slots: int
    topology: str = "sequential"           # capacity model the slots assume

    @property
    def is_cheap(self) -> bool:
        from ..runtime.lowering import is_cheap
        return is_cheap(self.lowering)

    def implementation(self, backend: str = "reference"):
        """This plan's `ChannelLowering` on the named registry backend."""
        from ..runtime.lowering import backend as _backend
        return _backend(backend).implementation(self.lowering)

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "pattern_before": self.pattern_before,
                "split": self.split,
                "parts": [list(p) for p in self.parts],
                "lowering": self.lowering, "buffer_slots": self.buffer_slots,
                "topology": self.topology}


#: `AnalysisReport` JSON format version.  Bump on any field change so
#: downstream artifacts (BENCH_*.json, the CI cache, saved reports) can
#: detect drift instead of mis-parsing.  v1 was the unversioned PR-2 format;
#: v2 added ``schema_version``, ``validation`` and per-plan ``topology``;
#: v3 added ``selftimed`` (the self-timed execution evidence);
#: v4 added ``resilience`` (the fault-matrix evidence);
#: v5 added ``parametric`` (symbolic verdicts + closed-form sizes; None on
#: concrete runs, so evaluated parametric reports stay byte-identical to
#: concrete analysis).
SCHEMA_VERSION = 5


@dataclass
class AnalysisReport:
    """The one JSON-serializable artifact of a pipeline run."""

    kernel: str
    params: Dict[str, int]
    stages: List[str]
    channels: List[Dict[str, Any]]    # name/depth/pattern before+after/slots
    fifoize: Optional[Dict[str, List[str]]]
    sizes_pow2: Optional[bool]
    total_slots: Optional[int]
    plans: Optional[List[Dict[str, Any]]]
    cache: Dict[str, Any]
    validation: Optional[Dict[str, Any]] = None   # validate-stage evidence
    selftimed: Optional[Dict[str, Any]] = None    # self-timed execution
    resilience: Optional[Dict[str, Any]] = None   # fault-matrix evidence
    parametric: Optional[Dict[str, Any]] = None   # symbolic verdicts/sizes
    schema_version: int = SCHEMA_VERSION

    def as_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "kernel": self.kernel, "params": dict(self.params),
            "stages": list(self.stages), "channels": self.channels,
            "fifoize": self.fifoize, "sizes_pow2": self.sizes_pow2,
            "total_slots": self.total_slots, "plans": self.plans,
            "validation": self.validation,
            "selftimed": self.selftimed,
            "resilience": self.resilience,
            "parametric": self.parametric,
            "cache": self.cache,
        }

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.as_dict(), **kwargs)

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "AnalysisReport":
        """Load a report emitted by `as_dict`/`to_json`, failing loudly on
        format drift (missing or unknown ``schema_version``)."""
        version = doc.get("schema_version")
        if version != SCHEMA_VERSION:
            raise ValueError(
                f"AnalysisReport schema_version {version!r} does not match "
                f"this build's {SCHEMA_VERSION} — regenerate the artifact "
                f"(v1 is the pre-versioning format)")
        return cls(**{f: doc[f] for f in (
            "kernel", "params", "stages", "channels", "fifoize", "sizes_pow2",
            "total_slots", "plans", "validation", "selftimed", "resilience",
            "parametric", "cache", "schema_version")})

    @classmethod
    def from_json(cls, text: str) -> "AnalysisReport":
        return cls.from_dict(json.loads(text))

    def summary(self) -> str:
        n = len(self.channels)
        fifo = sum(c["pattern_after"] == Pattern.FIFO.value
                   for c in self.channels)
        parts = [f"{self.kernel}: {fifo}/{n} FIFO"]
        if self.fifoize is not None:
            parts.append(f"split {len(self.fifoize['split_ok'])} ok / "
                         f"{len(self.fifoize['split_failed'])} failed")
        if self.total_slots is not None:
            parts.append(f"{self.total_slots} buffer slots")
        return ", ".join(parts)


def _source_name(c: Channel) -> str:
    """Name of the pre-SPLIT channel a (possibly split) channel came from."""
    return c.name.rsplit("@", 1)[0] if c.depth is not None else c.name


@dataclass(frozen=True)
class Analysis:
    """One immutable pipeline state.  Stage methods return a new `Analysis`
    sharing this one's `AnalysisContext`; `parent` links the chain so
    `report()` can show before/after without recomputing anything."""

    ppn: PPN
    ctx: AnalysisContext
    stages: Tuple[str, ...] = ("ppn",)
    parent: Optional["Analysis"] = None
    patterns: Optional[Mapping[str, Pattern]] = None
    fifoize_report: Optional[FifoizeReport] = None
    sizes: Optional[Mapping[str, int]] = None
    sizes_pow2: Optional[bool] = None
    plans: Optional[Tuple[ChannelPlan, ...]] = None
    validation: Optional[Any] = None       # runtime.validate.ValidationReport
    selftimed: Optional[Any] = None        # selftimed.SelfTimedValidation
    resilience: Optional[Any] = None       # resilience.ResilienceValidation

    # ------------------------------------------------------------- stages --

    def _next(self, stage: str, **changes) -> "Analysis":
        return replace(self, stages=self.stages + (stage,), parent=self,
                       **changes)

    def retile(self, tilings: Optional[Mapping[str, Tiling]] = None
               ) -> "Analysis":
        """A fresh base-stage `Analysis` of the SAME kernel under another
        tiling assignment, skipping everything tiling-independent.

        The dataflow oracle never reruns: the root PPN's `Channel` objects,
        domain arrays, `DomainIndex` row lookups, and per-process base
        timestamps/lex ranks are all carried over; downstream stages
        recompute only tile coordinates and the composite (φ, base) ranks.
        Results are identical to ``analyze(kernel, tilings=...)`` — retiling
        is pure amortization (`tests/test_sweep.py` asserts report parity on
        every PolyBench kernel).

        Processes absent from ``tilings`` become untiled, mirroring
        `PPN.from_kernel`.  The chain is walked back to its root first, so
        retiling a fifoized stage restarts from the original (unsplit)
        channels; the returned `Analysis` has a fresh `AnalysisContext` (per-
        tiling classifier/sizing caches must not leak across configurations).
        """
        root = self
        while root.parent is not None:
            root = root.parent
        ctx = AnalysisContext()
        # retile hops this chain descends from (diagnostics; fresh analyze
        # reads 0, a sweep configuration 1, a retile of a retile 2, …)
        ctx.counters["retiles"] = self.ctx.counters["retiles"] + 1
        return Analysis(ppn=root.ppn.retiled(tilings), ctx=ctx)

    def classify(self) -> "Analysis":
        """Classify every channel on the shared batched-rank path."""
        self.ctx.counters["classify_stages"] += 1
        pats = _classify_channels(self.ppn,
                                  classifier=self.ctx.classifier(self.ppn))
        return self._next("classify", patterns=pats)

    def fifoize(self) -> "Analysis":
        """SPLIT + FIFOIZE (paper Fig. 2) on the shared classifier; the new
        `Analysis` carries the rewritten PPN and its after-patterns."""
        self.ctx.counters["fifoize_stages"] += 1
        out, rep = _fifoize(self.ppn, classifier=self.ctx.classifier(self.ppn))
        return self._next("fifoize", ppn=out, fifoize_report=rep,
                          patterns=rep.after)

    def size(self, pow2: bool = True) -> "Analysis":
        """Channel capacities under the tiled sequential schedule (paper §4),
        on the shared per-process global-timestamp caches."""
        self.ctx.counters["size_stages"] += 1
        capture = (None if self.ctx.capture is None
                   else self.ctx.capture.setdefault("size_raw", {}))
        sizes = _size_channels(self.ppn, pow2=pow2,
                               context=self.ctx.sizing(self.ppn),
                               capture=capture)
        return self._next("size", sizes=sizes, sizes_pow2=pow2)

    def plan(self, topology: str = "sequential") -> "Analysis":
        """Pick a lowering per channel (comm backend).

        topology='sequential' — the paper's setting: program-order occupancy
        capacities, depth-SPLIT recovery only.
        topology='pipeline' — self-timed distributed stages: lockstep tick
        capacities and, beyond the paper, per-tile-pair (chunk) splitting for
        interleaved consumers (vpp schedules).
        """
        if topology not in ("sequential", "pipeline"):
            raise ValueError(f"unknown topology {topology!r}")
        self.ctx.counters["plan_stages"] += 1
        clf = self.ctx.classifier(self.ppn)
        if topology == "pipeline":
            cap = lambda ch: tick_capacity(self.ppn, ch)
        else:
            szctx = self.ctx.sizing(self.ppn)
            cap = lambda ch: _channel_capacity(self.ppn, ch, context=szctx)
        plans = tuple(
            self._plan_channel(ch, clf, cap, topology)
            for ch in self.ppn.channels)
        return self._next("plan", plans=plans)

    def _plan_channel(self, ch: Channel, clf: ChannelClassifier, cap,
                      topology: str) -> ChannelPlan:
        # the verdict→lowering mapping is the runtime registry's single
        # table; nothing here may hard-code a lowering name
        from ..runtime.lowering import lowering_for_pattern, split_lowering
        capture = self.ctx.capture

        def record(parts_raw: List[Tuple[int, int]]) -> None:
            # raw caps of the CHOSEN parts only (discarded split attempts
            # must not pollute the parametric fit samples)
            if capture is not None:
                capture.setdefault("plan_raw", {})[ch.name] = parts_raw

        before = clf.classify(ch)
        if before is Pattern.FIFO:
            raw = cap(ch)
            slots = pow2_size(raw)
            record([(0, raw)])
            return ChannelPlan(ch.name, before.value, False,
                               [(0, before.value, slots)],
                               lowering_for_pattern(before), slots, topology)
        splitters = [("depth-split", split_channel)]
        if topology == "pipeline":
            splitters.append(("chunk-split", split_by_tile_pair))
        for label, splitter in splitters:
            try:
                parts = splitter(self.ppn, ch)
            except NotApplicable:
                continue
            classified = [(p.depth, clf.classify(p), cap(p))
                          for p in parts]
            if all(pat is Pattern.FIFO for _, pat, _ in classified):
                record([(d, raw) for d, _, raw in classified])
                return ChannelPlan(
                    ch.name, before.value, True,
                    [(d, pat.value, pow2_size(raw))
                     for d, pat, raw in classified],
                    split_lowering(label),
                    sum(pow2_size(raw) for _, _, raw in classified),
                    topology)
        raw = cap(ch)
        slots = pow2_size(raw)
        record([(0, raw)])
        return ChannelPlan(ch.name, before.value, False,
                           [(0, before.value, slots)],
                           lowering_for_pattern(before), slots, topology)

    def validate(self, backend: str = "cuda",
                 mode: str = "trace", device=None) -> "Analysis":
        """Operationally validate every verdict and buffer size.

        mode='trace' — replay each channel's dataflow trace through the
        planned implementation on the named registry backend —
        ``"cuda"`` (the default: the traces through ring kernels on
        ``device``, ``None`` meaning ``"cuda"``) or ``"reference"``
        (vectorized numpy replay on the host) — positive AND negative
        directions — and cross-check
        peak occupancy against `size()` slots.

        mode='selftimed' — execute the WHOLE network event-driven under the
        planned capacities (every channel a bounded back-pressured queue):
        completion is observed (cyclic nets included), high-water marks are
        cross-checked against the trace simulator's exact peaks, and on
        cyclic nets every cycle channel's capacity is shrunk and the
        deadlock / stall-bound slowdown must name it
        (`runtime/selftimed/validate.py`; evidence on ``.selftimed``).

        mode='faults' — run the fault matrix: guarded executions with every
        applicable fault kind injected into representative channels/actors,
        plus wire-level faulted traces through the guarded channel
        implementations.  Every fault must be detected and either recovered
        (outputs equal to a fault-free oracle) or reported with a named
        culprit — never a silent wrong answer, never a hang
        (`runtime/resilience/validate.py`; evidence on ``.resilience``).

        The self-timed mode and the fault matrix's engine cases run on the
        host, and ``mode="selftimed"`` ignores ``backend`` and ``device``
        as the reference does.  ``mode="faults"`` replays its wire faults
        on ``"reference"`` and on ``backend`` (once where they are the
        same): on ``"cuda"``, kernel 3 (``csrc/replay.cu``) on ``device``
        (``None`` meaning ``"cuda"``).

        Raises `runtime.validate.ValidationError` on any contradiction."""
        if mode == "selftimed":
            from ..runtime.selftimed.validate import selftimed_validate
            self.ctx.counters["selftimed_stages"] += 1
            return self._next("selftimed",
                              selftimed=selftimed_validate(self))
        if mode == "faults":
            from ..runtime.resilience.validate import faults_validate
            self.ctx.counters["faults_stages"] += 1
            backends = tuple(dict.fromkeys(("reference", backend)))
            return self._next("faults", resilience=faults_validate(
                self, trace_backends=backends, device=device))
        if mode != "trace":
            raise ValueError(
                f"unknown mode {mode!r} (trace | selftimed | faults)")
        from ..runtime.validate import validate_analysis
        self.ctx.counters["validate_stages"] += 1
        return self._next("validate",
                          validation=validate_analysis(self, backend,
                                                       device=device))

    def compile(self, backend: str = "cuda", device=None, **options):
        """Compile the planned PPN to executable kernels via the named
        backend's whole-PPN ``compile`` hook (the cuda backend returns a
        `CompiledStencil`: the fused ring kernel when every plan is cheap,
        the addressable per-timestep fallback otherwise) that runs on
        ``device`` (``None`` meaning ``"cuda"``).  Unlike the stage methods
        this returns the executable, not an `Analysis` — running kernels is
        the pipeline's exit, not another stage."""
        from ..runtime.lowering import backend as _backend
        b = _backend(backend)
        if b.compile is None:
            raise TypeError(f"backend {backend!r} registers channel "
                            f"lowerings but no whole-PPN compile hook")
        return b.compile(self, device=device, **options)

    # ------------------------------------------------------------- report --

    def _patterns_before(self) -> Mapping[str, Pattern]:
        """Pre-FIFOIZE patterns: from the fifoize report when that stage ran,
        else the earliest classification in the chain, else current."""
        a: Optional[Analysis] = self
        best: Optional[Mapping[str, Pattern]] = None
        while a is not None:
            if a.fifoize_report is not None:
                return a.fifoize_report.before
            if a.patterns is not None:
                best = a.patterns
            a = a.parent
        return best if best is not None else self._current_patterns()

    def _current_patterns(self) -> Mapping[str, Pattern]:
        if self.patterns is not None:
            return self.patterns
        return _classify_channels(self.ppn,
                                  classifier=self.ctx.classifier(self.ppn))

    def report(self) -> AnalysisReport:
        """Assemble the artifact from whatever stages ran (classification is
        filled in from the shared caches if `.classify()` was skipped)."""
        after = self._current_patterns()
        before = self._patterns_before()
        plan_by_name = ({p.name: p for p in self.plans}
                        if self.plans is not None else {})
        channels: List[Dict[str, Any]] = []
        for c in self.ppn.channels:
            src = _source_name(c)
            row: Dict[str, Any] = {
                "name": c.name, "source": src, "depth": c.depth,
                "edges": c.num_edges,
                "pattern_before": before.get(src, after[c.name]).value,
                "pattern_after": after[c.name].value,
            }
            if self.sizes is not None:
                row["slots"] = self.sizes[c.name]
            if c.name in plan_by_name:
                row["lowering"] = plan_by_name[c.name].lowering
            channels.append(row)
        rep = self.fifoize_report
        return AnalysisReport(
            kernel=self.ppn.kernel_name,
            params=dict(self.ppn.params),
            stages=list(self.stages),
            channels=channels,
            fifoize=None if rep is None else {
                "split_ok": list(rep.split_ok),
                "split_failed": list(rep.split_failed),
                "untouched": list(rep.untouched)},
            sizes_pow2=self.sizes_pow2,
            total_slots=(None if self.sizes is None
                         else sum(self.sizes.values())),
            plans=(None if self.plans is None
                   else [p.as_dict() for p in self.plans]),
            validation=(None if self.validation is None
                        else self.validation.as_dict()),
            selftimed=(None if self.selftimed is None
                       else self.selftimed.as_dict()),
            resilience=(None if self.resilience is None
                        else self.resilience.as_dict()),
            cache=dict(self.ctx.counters,
                       polyhedron=polyhedron_cache_stats()),
        )


def analyze(kernel: Union[Kernel, PPN, Any],
            params: Optional[Mapping[str, int]] = None,
            tilings: Optional[Mapping[str, Tiling]] = None,
            sizes: Optional[Any] = None):
    """Entry point of the staged pipeline.

    Accepts a `Kernel` (the dataflow oracle runs once, here), an
    already-built `PPN` (e.g. from `comm.planner.pipeline_ppn`), any object
    with `.kernel` / `.tilings` attributes (a polybench `KernelCase`), or a
    builder program implementing `__kernelcase__()` (a `repro_torch.lang.Nest` —
    compiled and validated here, so malformed specs fail with diagnostics
    before any analysis runs).

    ``sizes=symbolic`` (the sentinel from `repro_torch.core.parametric`) switches
    to the parametric pipeline: the kernel's declared size parameters stay
    symbolic and the returned `ParametricAnalysis` proves/fits the whole
    report once, after which ``.evaluate(N=..., T=...)`` instantiates it for
    any concrete size in microseconds (byte-identical to a concrete run).
    A mapping ``sizes={"N": 32}`` is shorthand for concrete ``params``
    overrides."""
    if sizes is not None:
        from .parametric import ParametricAnalysis, symbolic
        if isinstance(sizes, Mapping):
            return analyze(kernel, params=dict(params or {}, **sizes),
                           tilings=tilings)
        if sizes is not symbolic and sizes != "symbolic":
            raise ValueError(
                f"sizes must be the `symbolic` sentinel (or a concrete "
                f"mapping), got {sizes!r}")
        return ParametricAnalysis.start(kernel, params=params,
                                        tilings=tilings)
    if hasattr(kernel, "__kernelcase__"):
        kernel = kernel.__kernelcase__()
    if isinstance(kernel, PPN):
        if params is not None or tilings is not None:
            raise ValueError("params/tilings are baked into a PPN already")
        ppn = kernel
    else:
        if hasattr(kernel, "kernel") and hasattr(kernel, "tilings"):
            case = kernel
            kernel = case.kernel
            tilings = dict(case.tilings, **(tilings or {}))
        ppn = PPN.from_kernel(kernel, params=params, tilings=tilings)
    return Analysis(ppn=ppn, ctx=AnalysisContext())
