"""Roofline models on one H100: the dry-run report CLI and the DSE
design-point cost predictor, and the roofline cache loader.

CLI (renders the dry-run cache's tables, `repro_torch.launch.dryrun`)::

    PYTHONPATH=src python -m repro_torch.launch.roofline
        [--cache results/dryrun_torch] [--markdown]

`render` is the reference's table; a term the port's dry run records as
null (``compile_s``) is an empty cell.

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
`HBM_BW`, shared memory at `SMEM_BW`, and the design points' arithmetic at
`PEAK_FLOPS_FP32`, since the ring kernels compute in float32 on the CUDA
cores, not on the tensor cores; the dry run's at `PEAK_FLOPS_BF16`, its
collectives' wire bytes at `LINK_BW`.
"""
import argparse
import json
import pathlib
import warnings
from typing import Any, Dict, List, Mapping, Tuple

from ..device import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32,
                      SMEM_BW)

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


def _sci(x) -> str:
    return "" if x is None else f"{x:.3e}"


def render(recs: List[Dict], mesh: str, markdown: bool = False) -> str:
    rows = []
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            rows.append((r["arch"], r["cell"], "SKIP", "", "", "", "", "", ""))
            continue
        if r.get("status") != "ok":
            rows.append((r["arch"], r["cell"], "ERR", "", "", "", "", "",
                         r.get("error", "")[:40]))
            continue
        rf = r["roofline"]
        uf = rf.get("useful_flops_ratio")
        compile_s = r.get("compile_s", "")
        rows.append((
            r["arch"], r["cell"], rf["dominant"],
            _sci(rf["compute_s"]), _sci(rf["memory_s"]),
            _sci(rf["collective_s"]),
            f"{r['memory']['peak_bytes_per_device']/2**30:.2f}",
            f"{uf:.3f}" if uf else "",
            "" if compile_s is None else f"{compile_s}s"))
    hdr = ("arch", "cell", "dominant", "compute_s", "memory_s",
           "collective_s", "HBM_GiB", "useful", "compile")
    if markdown:
        lines = ["| " + " | ".join(hdr) + " |",
                 "|" + "---|" * len(hdr)]
        lines += ["| " + " | ".join(str(c) for c in row) + " |" for row in rows]
        return "\n".join(lines)
    w = [22, 12, 10, 11, 11, 12, 8, 7, 8]
    lines = [" ".join(h.ljust(x) for h, x in zip(hdr, w))]
    lines += [" ".join(str(c).ljust(x) for c, x in zip(row, w)) for row in rows]
    return "\n".join(lines)


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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default="results/dryrun_torch")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()
    recs, skipped = load(pathlib.Path(args.cache))
    for mesh in ("16x16", "2x16x16"):
        print(f"### mesh {mesh} "
              f"(cards={'512' if mesh == '2x16x16' else '256'}, "
              f"H100 SXM: {PEAK_FLOPS_BF16/1e12:.0f} TF/s bf16, "
              f"{HBM_BW/1e9:.0f} GB/s HBM, {LINK_BW/1e9:.0f} GB/s "
              f"NVLink)")
        print(render(recs, mesh, args.markdown))
        print()
    if skipped:
        print(f"skipped {len(skipped)} unreadable cache record(s): "
              + ", ".join(skipped))


if __name__ == "__main__":
    main()
