"""Pareto frontiers over completed design points.

The objective space is the paper's communication trade, priced:

* ``fifo_fraction``   — maximize (share of compute↔compute channels the
  analysis recovers as FIFOs — paper Table 2's headline number);
* ``total_slots``     — minimize (aggregate buffer capacity the sizing
  stage allocates — paper Table 1's storage column);
* ``cost``            — minimize; the roofline prediction
  (``metrics.predicted_s``) by default, or measured generated-kernel
  seconds (``metrics.measured_s``) for the measured frontier, restricted
  to points that have one.

Dominance is the usual weak-dominance: ``a`` dominates ``b`` iff ``a`` is
at least as good on every objective and strictly better on one.  Dominated
points are not discarded — each carries ``dominated_by``, the key of one
point that beats it, so a frontier file documents *why* every losing
configuration lost (the provenance the resumable store exists to keep).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

#: (metrics key, direction); direction +1 = maximize, -1 = minimize
OBJECTIVES: Tuple[Tuple[str, int], ...] = (
    ("fifo_fraction", +1),
    ("total_slots", -1),
    ("cost", -1),
)


def objective_vector(point: Mapping[str, Any], cost_key: str = "predicted_s"
                     ) -> Optional[Tuple[float, float, float]]:
    """(fifo_fraction, total_slots, cost) of one result doc; None when the
    point has no usable metrics (error points, or no ``cost_key``)."""
    m = point.get("metrics")
    if not m or point.get("error"):
        return None
    cost = m.get(cost_key)
    if cost is None or m.get("fifo_fraction") is None \
            or m.get("total_slots") is None:
        return None
    return (float(m["fifo_fraction"]), float(m["total_slots"]), float(cost))


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Weak Pareto dominance of objective vectors (both already oriented via
    `OBJECTIVES` directions by `objective_vector` order)."""
    no_worse = (a[0] >= b[0] and a[1] <= b[1] and a[2] <= b[2])
    strictly = (a[0] > b[0] or a[1] < b[1] or a[2] < b[2])
    return no_worse and strictly


#: result-doc fields a frontier entry keeps — the point's identity, not its
#: execution record, so frontier files are byte-stable across reruns
#: (``provenance`` carries wall-clock timings; ``report`` is deterministic
#: but hundreds of lines per point and retrievable from the store by key)
POINT_FIELDS: Tuple[str, ...] = ("key", "kernel", "tiling_id", "topology",
                                 "sizes", "overrides", "override_id", "pow2")


def _trim(point: Mapping[str, Any]) -> Dict[str, Any]:
    doc = {k: point[k] for k in POINT_FIELDS if k in point}
    doc["metrics"] = dict(point.get("metrics") or {})
    return doc


def pareto_front(points: Sequence[Mapping[str, Any]],
                 cost_key: str = "predicted_s") -> Dict[str, Any]:
    """Split result docs into frontier and dominated sets.

    Returns ``{"objectives", "cost_key", "frontier": [...], "dominated":
    [...], "skipped": N}`` where every entry is ``{"key", "point",
    "vector"}`` (+ ``"dominated_by"``: the key of one dominating frontier
    point), ``point`` is the identity-and-metrics trim (`POINT_FIELDS` —
    look the key up in the store for the full report), and ``skipped``
    counts docs with no objective vector.  O(n²) — design-point sets are
    hundreds, not millions."""
    scored: List[Tuple[str, Mapping[str, Any], Tuple[float, ...]]] = []
    skipped = 0
    for p in points:
        vec = objective_vector(p, cost_key)
        if vec is None:
            skipped += 1
            continue
        scored.append((p.get("key") or "", p, vec))
    frontier, dominated = [], []
    for key, p, vec in scored:
        winner = next((k2 for k2, _, v2 in scored
                       if v2 != vec and dominates(v2, vec)), None)
        entry = {"key": key, "vector": list(vec), "point": _trim(p)}
        if winner is None:
            frontier.append(entry)
        else:
            dominated.append(dict(entry, dominated_by=winner))
    # deterministic order: best fifo fraction first, then fewest slots
    frontier.sort(key=lambda e: (-e["vector"][0], e["vector"][1],
                                 e["vector"][2], e["key"]))
    dominated.sort(key=lambda e: (-e["vector"][0], e["vector"][1],
                                  e["vector"][2], e["key"]))
    return {"objectives": [list(o) for o in OBJECTIVES],
            "cost_key": cost_key, "skipped": skipped,
            "frontier": frontier, "dominated": dominated}


def frontier_by_kernel(points: Sequence[Mapping[str, Any]],
                       cost_key: str = "predicted_s",
                       measured: bool = True) -> Dict[str, Any]:
    """Per-kernel frontiers over a whole experiment's result docs: for each
    kernel the predicted frontier and — where any point carries a measured
    kernel time — the measured frontier over that subset."""
    by_kernel: Dict[str, List[Mapping[str, Any]]] = {}
    for p in points:
        by_kernel.setdefault(p.get("kernel", "?"), []).append(p)
    out: Dict[str, Any] = {}
    for kernel in sorted(by_kernel):
        pts = by_kernel[kernel]
        doc: Dict[str, Any] = {"points": len(pts),
                               "errors": sum(1 for p in pts
                                             if p.get("error")),
                               "predicted": pareto_front(pts, cost_key)}
        if measured and any((p.get("metrics") or {}).get("measured_s")
                            is not None for p in pts):
            doc["measured"] = pareto_front(pts, "measured_s")
        out[kernel] = doc
    return out


def frontier_summary(frontiers: Mapping[str, Any]) -> List[str]:
    """One human line per kernel (the CLI/status rendering)."""
    lines = []
    for kernel, doc in frontiers.items():
        fr = doc["predicted"]["frontier"]
        best = fr[0]["vector"] if fr else None
        extra = f", measured frontier {len(doc['measured']['frontier'])}" \
            if "measured" in doc else ""
        lines.append(
            f"{kernel:12s} {doc['points']:4d} points "
            f"({doc['errors']} errors), frontier {len(fr)}"
            + (f", best fifo {best[0]:.2f} @ {int(best[1])} slots"
               if best else "") + extra)
    return lines
