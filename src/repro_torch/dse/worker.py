"""Design-point evaluation: one `GroupTask` in, one result doc per point out.

A group is a (kernel, tiling, topology, override) cell with its whole size
axis.  In ``size_mode="parametric"`` the worker builds ONE symbolic template
(`core.parametric`) for the cell — classify → fifoize → size → plan(topology) — and
instantiates it per size point in microseconds; any size off the template's
proved lattice, or a template that does not close, falls back to a concrete
per-size analysis with the fallback recorded in the point's provenance
(never silent).  ``size_mode="concrete"`` runs the staged driver per size.

Failures follow the sweep engine's per-job contract (`core.sweep.run_job`):
an exception evaluating one point becomes a *named error result* for that
point — ``{"error": {"type", "message"}}`` — and the rest of the group (and
fleet) keeps going.

Every successful point carries:

* ``metrics`` — the frontier axes: ``fifo_fraction`` over compute↔compute
  channels (the paper's tables count those), ``total_slots`` (whole network)
  and ``compute_slots``, plus the roofline prediction
  (`repro_torch.launch.roofline.predict_report_cost`);
* ``measured`` — where requested and the cuda backend applies
  (`STENCIL_PROGRAMS`), the generated kernel's device seconds on the card
  (`measure_compiled`) with its geometry, mode and the card's name;
  absent otherwise.  A measurement the geometry or the device refuses
  (``ValueError``) becomes a "measure skipped" note; any other failure (a
  CUDA error, a failed build) makes the point an error;
* ``provenance`` — how the number was produced: ``size_mode`` actually used
  per point, fallback reasons, applied lowering overrides, seconds spent.
"""
from __future__ import annotations

import fnmatch
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..core.analysis import analyze
from ..core.sweep import report_payload
from ..launch.roofline import predict_report_cost
from .experiment import GroupTask, config_from_doc


def _error_doc(exc: BaseException) -> Dict[str, Any]:
    return {"type": type(exc).__name__, "message": str(exc)}


# ----------------------------------------------------------- plan override --

def apply_lowering_overrides(doc: Dict[str, Any],
                             overrides: Optional[Mapping[str, str]]
                             ) -> Tuple[Dict[str, Any], List[Dict[str, str]]]:
    """Rewrite plan/channel lowering fields per fnmatch override map; the
    returned provenance lists every (channel, from, to) rewrite so an
    overridden point can never be mistaken for a planned one."""
    if not overrides:
        return doc, []
    applied: List[Dict[str, str]] = []
    for plan in doc.get("plans") or ():
        for pattern, lowering in overrides.items():
            if fnmatch.fnmatchcase(plan["name"], pattern) \
                    and plan["lowering"] != lowering:
                applied.append({"channel": plan["name"],
                                "from": plan["lowering"], "to": lowering})
                plan["lowering"] = lowering
    by_name = {a["channel"]: a["to"] for a in applied}
    for ch in doc.get("channels", ()):
        if ch.get("lowering") is not None and ch["name"] in by_name:
            ch["lowering"] = by_name[ch["name"]]
    return doc, applied


# ---------------------------------------------------------------- metrics ---

def point_metrics(doc: Mapping[str, Any], compute: Tuple[str, ...]
                  ) -> Dict[str, Any]:
    """The frontier axes from one report dict (`bench_sweep`'s compute-
    channel accounting + the roofline prediction)."""
    comp = set(compute)
    rows = [c for c in doc["channels"]
            if c["name"].split("->", 1)[0] in comp
            and c["name"].split("->", 1)[1].split(".", 1)[0] in comp]
    fifo = sum(r["pattern_after"] == "fifo" for r in rows)
    cost = predict_report_cost(doc)
    return {"compute_channels": len(rows), "fifo_channels": fifo,
            "fifo_fraction": round(fifo / max(len(rows), 1), 4),
            "total_slots": doc.get("total_slots"),
            "compute_slots": sum(r.get("slots", 0) for r in rows),
            "predicted_s": cost["predicted_s"],
            "roofline": cost}


# ------------------------------------------------------------ measurement ---

def _measure_point(kernel_name: str, analysis, sizes: Optional[Mapping],
                   tiling_cfg, spec: Mapping[str, Any]
                   ) -> Optional[Dict[str, Any]]:
    """Time the generated CUDA kernel for this point on ``spec["device"]``
    (``None`` meaning ``"cuda"``), if the backend applies; None (with no
    side effects) where it does not.  The compile picks the fused ring or,
    for a reorder-buffer plan, the addressable fallback, as the plan says.
    Raises ValueError where the geometry or the device cannot be timed."""
    from ..runtime.cuda_codegen import STENCIL_PROGRAMS
    if kernel_name not in STENCIL_PROGRAMS:
        return None
    from ..runtime.cuda_backend import measure_compiled
    compiled = analysis.compile(backend="cuda", device=spec.get("device"))
    block = max(int(b) for t in tiling_cfg.values() for b in t.sizes)
    radius = compiled.program.radius
    # smallest geometry the kernel accepts around the point's size: steps a
    # multiple of block/gcd so skewed writes stay aligned, n >= 4 blocks
    steps = block if (radius * block) % block == 0 else block * radius
    n = max(int(next(iter(sizes.values()))) if sizes else 4 * block,
            4 * block)
    n += (-n) % block
    return measure_compiled(compiled, n, steps, block,
                            repeats=int(spec.get("repeats", 1)))


# ------------------------------------------------------------- group runs ---

def _evaluate_concrete(kernel, env, cfg, topology, pow2):
    a = (analyze(kernel, params=None if env is None else dict(env),
                 tilings=cfg)
         .classify().fifoize().size(pow2=pow2).plan(topology=topology))
    return a, report_payload(a.report())


def run_group(task_doc: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """Evaluate every point of one group task (a dict, JSON/pickle-safe —
    the unit all three execution managers ship).  Returns one result doc per
    size point, in axis order, each carrying its design-point identity and
    key so the caller can persist it without re-deriving anything."""
    from ..core.polybench import get
    from ..core.parametric import ParametricAnalysis, ParametricFallbackWarning

    task = GroupTask.from_dict(task_doc)
    points = task.points()
    results: List[Dict[str, Any]] = []
    try:
        case = get(task.kernel)
        cfg = config_from_doc(task.tiling)
    except Exception as e:                       # unknown kernel, bad tiling
        return [dict(p.as_dict(), error=_error_doc(e)) for p in points]

    template = None
    template_note: Optional[str] = None
    t_build = 0.0
    if task.size_mode == "parametric" and any(
            p.sizes is not None for p in points):
        t0 = time.perf_counter()
        try:
            pa = ParametricAnalysis.start(case.kernel, tilings=cfg)
            pa = (pa.classify().fifoize().size(pow2=task.pow2)
                  .plan(topology=task.topology))
            with warnings.catch_warnings(record=True) as ws:
                warnings.simplefilter("always", ParametricFallbackWarning)
                pa.prepare()
            if pa.status == "symbolic":
                template = pa
            else:
                template_note = "; ".join(str(w.message) for w in ws) \
                    or "template did not close"
        except Exception as e:
            template_note = f"{type(e).__name__}: {e}"
        t_build = time.perf_counter() - t0

    for i, point in enumerate(points):
        t0 = time.perf_counter()
        row = point.as_dict()
        try:
            analysis = None
            mode = "concrete"
            notes: List[str] = []
            if template is not None and point.sizes is not None:
                with warnings.catch_warnings(record=True) as ws:
                    warnings.simplefilter("always",
                                          ParametricFallbackWarning)
                    doc = report_payload(template.evaluate(**point.sizes))
                if ws:                          # off-lattice → concrete ran
                    notes.extend(str(w.message) for w in ws)
                    mode = "concrete-fallback"
                else:
                    mode = "parametric"
            else:
                if task.size_mode == "parametric" and template_note:
                    notes.append(f"template fallback: {template_note}")
                    mode = "concrete-fallback"
                analysis, doc = _evaluate_concrete(
                    case.kernel, point.sizes, cfg, task.topology, task.pow2)
            doc, applied = apply_lowering_overrides(doc, task.overrides)
            row["report"] = doc
            row["metrics"] = point_metrics(doc, case.compute)
            row["provenance"] = {
                "size_mode": mode, "notes": notes,
                "overrides_applied": applied,
                "template_build_s": round(t_build, 6) if i == 0 else 0.0,
                "seconds": round(time.perf_counter() - t0, 6)}
            if task.measure is not None \
                    and i < int(task.measure.get("max_points", 2)) \
                    and not applied:            # measured kernel ≡ the plan
                if analysis is None:            # parametric path has no
                    analysis, _ = _evaluate_concrete(   # Analysis object
                        case.kernel, point.sizes, cfg, task.topology,
                        task.pow2)
                # a geometry or device the kernel refuses is skipped,
                # loudly; any other failure (a CUDA error, a failed build)
                # reaches the handler below and makes the point an error
                try:
                    m = _measure_point(task.kernel, analysis, point.sizes,
                                       cfg, task.measure)
                except ValueError as e:
                    row["provenance"]["notes"].append(
                        f"measure skipped: {type(e).__name__}: {e}")
                else:
                    if m is not None:
                        row["measured"] = m
                        row["metrics"]["measured_s"] = m["seconds"]
        except Exception as e:
            row["error"] = _error_doc(e)
            row["provenance"] = {
                "seconds": round(time.perf_counter() - t0, 6)}
        results.append(row)
    if template is not None:
        template.release()
    return results
