"""Incremental tile-sweep engine: many tilings, one analysis' worth of work.

The paper's central observation is that FIFO recoverability is a function of
the chosen loop tiling — which makes "same kernel, many tilings" the analysis
engine's hottest realistic workload (tile-size selection is a first-class
design-space-exploration problem in HLS practice).  Naively that costs a full
`analyze(case)` per configuration; almost all of it is tiling-independent.

`sweep` runs the staged driver once per configuration through
`Analysis.retile`, reusing the PPN (dataflow relation + domains), the
`DomainIndex` row lookups, and the per-process base timestamps/lex ranks
across every configuration.  Reports are identical to a fresh `analyze()`
per tiling — the sweep is pure amortization (asserted field-for-field, modulo
the execution-diagnostics ``cache`` field, in `tests/test_sweep.py` and
enforced by `benchmarks/bench_sweep.py`).

`sweep_parallel` fans a list of `SweepJob`s out over a process pool (one
worker per kernel by default) and merges each worker's polyhedron verdict
cache back into the parent, so a subsequent `save_polyhedron_cache` persists
the union — repeated benchmark/CI runs start warm.
"""
from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

from .analysis import Analysis, AnalysisReport, analyze
from .dataflow import Kernel
from .polyhedron import export_polyhedron_cache, merge_polyhedron_cache
from .ppn import PPN
from .tiling import Tiling

#: stages `sweep` runs per configuration, in order (the paper's flow)
DEFAULT_STAGES: Tuple[str, ...] = ("classify", "fifoize", "size")

#: report fields that describe the execution rather than the analysis —
#: excluded from identity comparisons (cache hit counts are global process
#: state and differ even between two fresh `analyze()` runs)
DIAGNOSTIC_FIELDS: Tuple[str, ...] = ("cache",)


def report_payload(report: Union[AnalysisReport, Mapping[str, Any]]
                   ) -> Dict[str, Any]:
    """A report as a dict with execution diagnostics stripped — the value two
    runs of the same analysis must agree on byte-for-byte."""
    doc = report.as_dict() if isinstance(report, AnalysisReport) else dict(report)
    for k in DIAGNOSTIC_FIELDS:
        doc.pop(k, None)
    return doc


def _run_stages(a: Analysis, stages: Sequence[str], pow2: bool,
                topology: str) -> Analysis:
    for stage in stages:
        if stage == "classify":
            a = a.classify()
        elif stage == "fifoize":
            a = a.fifoize()
        elif stage == "size":
            a = a.size(pow2=pow2)
        elif stage == "plan":
            a = a.plan(topology=topology)
        elif stage == "validate":
            a = a.validate()
        else:
            raise ValueError(f"unknown sweep stage {stage!r}")
    return a


def _size_grid(sizes: Mapping[str, Any]) -> List[Dict[str, int]]:
    """A ``sizes`` mapping (param → value or list of values) as the list of
    concrete size points, in Cartesian-product order with the last parameter
    varying fastest."""
    import itertools
    axes = [(p, list(vals) if isinstance(vals, (list, tuple, range))
             else [vals]) for p, vals in sizes.items()]
    return [dict(zip((p for p, _ in axes), pt))
            for pt in itertools.product(*(vals for _, vals in axes))]


def sweep(kernel: Union[Kernel, PPN, Any],
          tilings: Sequence[Mapping[str, Tiling]],
          params: Optional[Mapping[str, int]] = None,
          *,
          sizes: Optional[Mapping[str, Any]] = None,
          stages: Sequence[str] = DEFAULT_STAGES,
          pow2: bool = True,
          topology: str = "sequential") -> List[AnalysisReport]:
    """Analyze one kernel under every tiling configuration in ``tilings``.

    ``kernel`` is anything `analyze` accepts (a `Kernel`, a prebuilt `PPN`,
    a polybench `KernelCase`, or a `repro_torch.lang` builder program — a case's
    or program's own tiling is ignored here; the swept configurations come
    from ``tilings``).  Each configuration maps process names to `Tiling`s
    exactly like `PPN.from_kernel`; unmapped processes are untiled.  Returns
    one `AnalysisReport` per configuration, in order, each identical to a
    fresh ``analyze(kernel, tilings=cfg)`` running the same stages.

    ``sizes`` adds a second sweep axis over concrete size points (param →
    list of values, expanded as a Cartesian grid).  The kernel is analyzed
    **symbolically once per tiling configuration** (`ParametricAnalysis`)
    and instantiated per size point — reports come back cfg-major
    (all size points of configuration 0, then configuration 1, …), each
    identical to a fresh concrete ``analyze(kernel, params=pt,
    tilings=cfg)``.  Size points off a template's proved lattice fall back
    to concrete analysis with a `ParametricFallbackWarning`.
    """
    if hasattr(kernel, "__kernelcase__"):
        kernel = kernel.__kernelcase__()    # lang program → compiled case
    if hasattr(kernel, "kernel") and hasattr(kernel, "tilings"):
        kernel = kernel.kernel          # a KernelCase; sweep supplies tilings
    reports: List[AnalysisReport] = []
    if sizes is not None:
        from .parametric import ParametricAnalysis
        grid = _size_grid(sizes)
        for cfg in tilings:
            pa = _run_stages(
                ParametricAnalysis.start(kernel, params=params,
                                         tilings=cfg),
                stages, pow2, topology)
            for pt in grid:
                reports.append(pa.evaluate(**pt))
            pa.release()
        return reports
    base = analyze(kernel, params=params)      # dataflow oracle runs ONCE
    for cfg in tilings:
        a = _run_stages(base.retile(cfg), stages, pow2, topology)
        reports.append(a.report())
    return reports


# ------------------------------------------------------- process-pool driver

@dataclass(frozen=True)
class SweepJob:
    """One worker's unit: a registered polybench kernel + its configurations.
    (Keyed by registry name so only small, picklable specs cross the pool.)"""

    kernel: str
    tilings: Tuple[Mapping[str, Tiling], ...]
    scale: int = 1
    stages: Tuple[str, ...] = DEFAULT_STAGES
    pow2: bool = True
    topology: str = "sequential"


def _job_error(job: SweepJob, index: int, exc: BaseException
               ) -> Dict[str, Any]:
    """The named per-configuration error record `run_job` emits in place of
    a report when one configuration fails."""
    return {"error": {"kernel": job.kernel, "config_index": index,
                      "type": type(exc).__name__, "message": str(exc)}}


def run_job(job: SweepJob) -> List[Dict[str, Any]]:
    """Execute one job in-process; reports as plain dicts (JSON/pickle-safe).

    Failures are **contained per configuration**: a configuration whose
    analysis raises yields ``{"error": {"kernel", "config_index", "type",
    "message"}}`` in its slot and the remaining configurations still run —
    one degenerate tiling cannot kill a fleet sweep.  A job-level failure
    (unknown kernel name, dataflow-oracle error) fills every slot with the
    same record.  Successful slots are unchanged: the same report dicts a
    fresh per-tiling ``analyze()`` would produce."""
    from .polybench import get
    try:
        case = get(job.kernel, job.scale)
        base = analyze(case.kernel)            # dataflow oracle runs ONCE
    except Exception as e:
        return [_job_error(job, i, e) for i in range(len(job.tilings))]
    out: List[Dict[str, Any]] = []
    for i, cfg in enumerate(job.tilings):
        try:
            a = _run_stages(base.retile(cfg), job.stages, job.pow2,
                            job.topology)
            out.append(a.report().as_dict())
        except Exception as e:
            out.append(_job_error(job, i, e))
    return out


def _pool_worker(payload) -> Tuple[int, List[Dict[str, Any]], Dict]:
    index, job = payload
    try:
        return index, run_job(job), export_polyhedron_cache()
    except BaseException as e:      # run_job contains per-config failures;
        return index, [_job_error(job, i, e)     # this guards the plumbing
                       for i in range(len(job.tilings))], {}


def sweep_parallel(jobs: Sequence[SweepJob],
                   max_workers: Optional[int] = None,
                   share_cache: bool = True) -> List[List[Dict[str, Any]]]:
    """Run ``jobs`` over a process pool; returns per-job report lists in job
    order.  Each worker seeds its polyhedron cache from the parent's (once,
    via the pool initializer) and the parent merges every worker's cache
    back afterwards, so sweeping in parallel leaves the parent exactly as
    warm as sweeping serially — and a following `save_polyhedron_cache`
    persists the union.  Reports are unchanged by parallelism (each job is
    computed independently).  Failures follow `run_job`'s contract: a bad
    configuration (or a job that dies wholesale) comes back as named
    ``{"error": ...}`` records in its slots, never as a pool exception."""
    if not jobs:
        return []
    init, initargs = None, ()
    if share_cache:
        init, initargs = merge_polyhedron_cache, (export_polyhedron_cache(),)
    out: List[Optional[List[Dict[str, Any]]]] = [None] * len(jobs)
    with ProcessPoolExecutor(max_workers=max_workers, initializer=init,
                             initargs=initargs) as pool:
        for index, reports, worker_cache in pool.map(
                _pool_worker, list(enumerate(jobs))):
            out[index] = reports
            if share_cache and worker_cache:
                merge_polyhedron_cache(worker_cache)
    return out
