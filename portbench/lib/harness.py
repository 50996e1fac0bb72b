"""One run of one cell: the driver's set-up, the measured window, the
traced window where asked, the check against the reference, the metrics
read by their readers, and the result's line."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from .compare import Check
from .manifest import Manifest
from .plugins import load_module

#: top-level module names that may not be loaded in a run: the JAX stack
#: and the reference package (compared whole: ``repro_torch`` is not
#: ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Context:
    """What a run knows, for the metrics' readers.  A driver fills its own
    fields and may add others under ``extra``; a reader that finds nothing
    it needs returns None."""

    cell: str
    seed: int
    config: dict
    mix: dict
    device: object
    chips: int = 1
    setup_s: Optional[float] = None
    spans: Dict[str, float] = field(default_factory=dict)  # host seconds
    jobs: int = 0                       # whole jobs in the measured window
    window_s: Optional[float] = None    # host seconds of those jobs
    launches: Dict[str, int] = field(default_factory=dict)  # in the window
    sweeps: int = 0                     # work units (sweeps) a job does
    work: Optional[object] = None       # the program's frozen work counts
    trace: Optional[object] = None      # lib.trace.TraceSummary
    memory_peak_bytes: Optional[int] = None
    extra: Dict[str, object] = field(default_factory=dict)


def forbidden_modules() -> List[str]:
    """The `FORBIDDEN` top-level names among the loaded modules."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class ForbiddenModules(RuntimeError):
    pass


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float, log=sys.stderr,
             spans: Optional[Dict[str, float]] = None) -> dict:
    """Run cell ``workload`` of the benchmark at ``root`` once on
    ``device`` and return its result (the keys of the result's line).
    ``t0`` is the host clock at the process's start, where set-up begins;
    ``spans`` are set-up spans the caller took before.  Raises where the
    run cannot be made as the cell says."""
    import torch

    bench = Manifest.load(root)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    driver_module = load_module(bench.folder / "drivers", config["driver"])
    ctx = Context(workload, seed, config, mix, device, cell["chips"])
    ctx.spans.update(spans or {})
    ctx.spans["imports"] = time.perf_counter() - t0
    driver = driver_module.make(bench.folder, ctx, log)
    cuda = torch.device(device).type == "cuda"
    if cuda:        # the context, so that no layer's span takes it
        t = time.perf_counter()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
        ctx.spans["cuda_init"] = time.perf_counter() - t
    driver.setup(ctx)
    ctx.setup_s = time.perf_counter() - t0
    print("set-up spans (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in ctx.spans.items()), file=log)
    driver.window(seconds, ctx)
    if cuda:
        ctx.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if trace:
        driver.traced(ctx)
    checks: List[Check] = driver.check(ctx)

    wanted = bench.end_to_end(workload) if not trace else \
        bench.per_layer(workload)
    metrics = {}
    for m in wanted:
        value = load_module(bench.folder / "metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": ctx.extra.get("attempted", ctx.jobs),
        "failed": ctx.extra.get("failed", 0),
        "metrics": metrics,
        "device": device_record(device, ctx, trace),
    }
    if trace and ctx.trace is not None:
        result["breakdown"] = {
            "device_ops": [list(t) for t in ctx.trace.device_ops],
            "idle_gaps": [list(t) for t in ctx.trace.idle_gaps]}
    result["checks"] = {c.name: c.as_dict() for c in checks}
    # last, once every check and every metric's reader has run: whatever
    # the run loaded is in `sys.modules` now
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules loaded that the port may not load: "
                               f"{found}")
    for c in checks:
        print(c.line(), file=log)
    return result


def device_record(device, ctx: Context, trace: bool) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": None}
    else:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": ctx.chips,
               "memory_peak_bytes": ctx.memory_peak_bytes}
    if trace and ctx.trace is not None:
        out["busy_s"] = ctx.trace.busy_s
        out["window_s"] = ctx.trace.window_s
    return out

