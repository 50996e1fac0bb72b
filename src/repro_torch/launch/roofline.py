"""The DSE design-point cost predictor on one H100, and the roofline cache
loader.

`predict_report_cost` is the analytic half of the DSE Pareto frontier
(`repro_torch.dse`): given one design point's `AnalysisReport` it prices the
channel traffic each planned lowering implies — cheap lowerings (streams,
the broadcast register) stay in the generated ring's shared memory, the
addressable reorder buffer round-trips device memory — and returns the
roofline max of the compute and memory terms.  It is a *ranking* model
(deliberately simple, microseconds to evaluate, monotone in the trade the
paper makes: losing a FIFO verdict moves that channel's bytes from shared
memory to device memory), not a simulator; where the cuda backend applies,
the DSE pairs it with measured generated-kernel time
(`repro_torch.runtime.cuda_backend.measure_compiled`).

The rates are the card's (`repro_torch.device`): device memory at
`HBM_BW`, shared memory at `SMEM_BW`, and the arithmetic at
`PEAK_FLOPS_FP32`, since the ring kernels compute in float32 on the CUDA
cores, not on the tensor cores.
"""
import json
import pathlib
import warnings
from typing import Any, Dict, List, Mapping, Tuple

from ..device import HBM_BW, PEAK_FLOPS_FP32, SMEM_BW

#: bytes per streamed token (the analyses carry f32 channel values)
TOKEN_BYTES = 4
#: FLOPs charged per dependence edge (one fused multiply-add per consumed
#: token — the stencil/linear-algebra kernels' per-edge arithmetic)
FLOPS_PER_EDGE = 2


def load(cache: pathlib.Path) -> Tuple[List[Dict], List[str]]:
    """Read every record in a cache directory of JSON records.  Returns
    ``(records, skipped)`` where ``skipped`` names the files that failed to
    parse — each is also warned about (a corrupt cache record must be
    visible, not a silently thinner report)."""
    out, skipped = [], []
    for f in sorted(cache.glob("*.json")):
        try:
            out.append(json.loads(f.read_text()))
        except Exception as e:
            skipped.append(str(f))
            warnings.warn(f"roofline: skipping unreadable cache record "
                          f"{f}: {type(e).__name__}: {e}")
    return out, skipped


def predict_report_cost(report: Mapping[str, Any]) -> Dict[str, float]:
    """Roofline prediction for one design point (an `AnalysisReport` dict
    with the ``plan`` stage run).

    Per channel: ``edges`` tokens move through the planned lowering —
    streams/registers at shared-memory bandwidth, the addressable reorder
    buffer as a device-memory round trip (write + read, the cost
    `runtime/cuda_codegen`'s addressable fallback actually pays per
    timestep).  Compute charges `FLOPS_PER_EDGE` per dependence edge.
    Returns the terms and their roofline max, ``predicted_s``."""
    doc = report if isinstance(report, Mapping) else report.as_dict()
    lowering_by_name: Dict[str, str] = {}
    for plan in doc.get("plans") or ():
        lowering_by_name[plan["name"]] = plan["lowering"]
    from ..runtime.lowering import is_cheap
    hbm = smem = edges = 0
    for ch in doc.get("channels", ()):
        n = int(ch.get("edges", 0))
        edges += n
        lowering = lowering_by_name.get(ch["name"],
                                        ch.get("lowering", "ppermute"))
        if is_cheap(lowering):
            smem += n * TOKEN_BYTES
        else:
            hbm += 2 * n * TOKEN_BYTES            # round trip
    compute_s = edges * FLOPS_PER_EDGE / PEAK_FLOPS_FP32
    memory_s = hbm / HBM_BW + smem / SMEM_BW
    return {"compute_s": compute_s, "memory_s": memory_s,
            "hbm_bytes": float(hbm), "smem_bytes": float(smem),
            "predicted_s": max(compute_s, memory_s),
            "dominant": "compute" if compute_s >= memory_s else "memory"}
