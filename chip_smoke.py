#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) once on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a host with a CUDA device and the CUDA
toolkit.  The phases, each of which raises (and so exits non-zero) on
failure:

1. Build the three CUDA kernels from `src/repro_torch/csrc` (one nvcc per
   source, in parallel).
2. The main path, with every kernel's launch count set to 0 first: for
   jacobi-1d, jacobi-2d and heat-3d at PolyBench/C 4.2.1's EXTRALARGE sizes
   (N = 4000, 2800, 200; TSTEPS = 1000), ``analyze(get(k)).classify()
   .fifoize().size().plan().compile(backend="cuda")`` must pick the fused
   ring; T = 1000 runs as 125 chained calls with a time tile of
   steps = block = 8 and must match the PyTorch oracle on the card.  The
   same job forced to ``mode="addressable"`` (1000 launches) must too.
   Then ``validate(backend="cuda")`` must give 14/17/35 replays and 3/8/12
   negative rejections, and a wrong plan must raise.  The counts are read
   here: every kernel must have launched.
3. The undersized-ring and narrowed-halo injections must diverge from the
   oracle, at a small size.
4. Each kernel is held against its plain PyTorch version on the same
   inputs: at small shapes (block = 1 and the injections included) and at
   the main path's shapes.
5. Each kernel is timed with CUDA events at the main path's shapes, beside
   its plain version, its bound and, where one PyTorch call computes the
   same function, that call.

Tolerances.  The kernels compute the same float32 operations in the same
order as the plain versions and the oracles (built with -fmad=false, so no
multiply is fused into an add).  One difference is left: on the card,
PyTorch divides by a Python scalar by multiplying with its rounded
reciprocal, and the kernels divide exactly.  fl(1/3) and fl(1/5) are
3.0e-8 and 1.5e-8 too large relative to 1/3 and 1/5, and that bias
compounds over the steps.  So one call (8 steps) and everything at small
shapes is held to rtol = atol = 1e-5, and the 1000-step jobs against the
oracle to rtol = 1000 * 2**-22 (2.4e-4, twice the worst compounded bias of
one rounding per step), atol = 1e-5.  The two kernel paths both divide
exactly, so the fused ring and the addressable fallback are held to each
other at rtol = atol = 1e-5 after the 1000 steps.

The last lines are the card's name and power limit, one JSON line with the
kernels' numbers, and ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, the script exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: PolyBench/C 4.2.1 EXTRALARGE_DATASET (jacobi-1d.h, jacobi-2d.h, heat-3d.h)
SIZES = {"jacobi-1d": (4000,), "jacobi-2d": (2800, 2800),
         "heat-3d": (200, 200, 200)}
TSTEPS = 1000
STEPS = BLOCK = 8                       # time tile; divides every size and T
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_LONG = dict(rtol=TSTEPS * 2 ** -22, atol=1e-5)   # see the docstring
#: replays and negative rejections of validate (the reference's evidence)
VALIDATE = {"jacobi-1d": (14, 3), "jacobi-2d": (17, 8), "heat-3d": (35, 12)}
#: small shapes for the kernel-vs-plain checks: (shape, steps, blocks)
SMALL = {"jacobi-1d": ((32,), 4, (1, 2, 4)),
         "jacobi-2d": ((16, 40), 4, (1, 4)),
         "heat-3d": ((8, 6, 5), 2, (1, 2))}
#: float32 operations a cell takes in one step of each update
FLOPS_PER_CELL = {"jacobi-1d": 3, "jacobi-2d": 5, "heat-3d": 15}
REPLACES = {
    "ring_stencil": "src/repro/runtime/pallas_codegen.py:142",
    "addressable_step": "src/repro/runtime/pallas_codegen.py:190",
    "replay": "src/repro/runtime/pallas_backend.py:126",
}
SOURCES = {
    "ring_stencil": "src/repro_torch/csrc/ring_stencil.cu",
    "addressable_step": "src/repro_torch/csrc/addressable_step.cu",
    "replay": "src/repro_torch/csrc/replay.cu",
}


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    import repro_torch.core.polybench  # noqa: F401  (populate the registry)
    from repro_torch import device as h100
    from repro_torch.core import Pattern, analyze
    from repro_torch.core.registry import get
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.stencil_fifo import hbm_traffic_model
    from repro_torch.runtime import FIFO_STREAM, ValidationError
    from repro_torch.runtime import cuda_backend as cb
    from repro_torch.runtime import cuda_codegen as cg
    from repro_torch.runtime.simulator import trace_channel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    def on_card(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def max_err(a, b) -> float:
        return float((a.double() - b.double()).abs().max())

    def close(a, b) -> bool:
        return bool(torch.allclose(a, b, **TOL))

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(launch, reps: int) -> float:
        """Device time per launch: CUDA events around ``reps`` raw launches
        queued back to back (no wrapper on the host path, so the device,
        not the host's enqueue, sets the pace)."""
        launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def planned(name):
        return analyze(get(name)).classify().fifoize().size().plan()

    # ---------------------------------------------------------- phase 1 --
    secs = cuda_lib.build_all(cuda_lib.KERNELS)
    say(f"phase 1 build: {json.dumps(secs)}")
    for k in cuda_lib.KERNELS:
        for line in k.ptxas_log.splitlines():
            if "Used" in line or "spill" in line:
                say(f"  {k.source.name}: {line.strip()}")

    # ---------------------------------------------------------- phase 2 --
    kernels = {"ring_stencil": cuda_lib.RING_STENCIL,
               "addressable_step": cuda_lib.ADDRESSABLE_STEP,
               "replay": cuda_lib.REPLAY}
    for k in kernels.values():
        k.launches = 0
    launches = {}                                 # (kernel, stencil) -> n
    inputs, walls = {}, {}

    def counted(stencil, fn):
        before = {n: k.launches for n, k in kernels.items()}
        out = fn()
        torch.cuda.synchronize()
        for n, k in kernels.items():
            if k.launches - before[n]:
                launches[(n, stencil)] = (launches.get((n, stencil), 0)
                                          + k.launches - before[n])
        return out

    for name, shape in SIZES.items():
        a = planned(name)
        c = a.compile(backend="cuda")
        check(c.mode == "fifo-ring", f"{name}: {c.describe()}")
        x = on_card(shape)
        inputs[name] = x

        def fused():
            y = x
            for _ in range(TSTEPS // STEPS):
                y = c(y, STEPS, BLOCK)
            return y

        t0 = time.perf_counter()
        y = counted(name, fused)
        fused_s = time.perf_counter() - t0
        want = c.program.ref(x, TSTEPS)
        check(tuple(y.shape) == shape and bool(torch.isfinite(y).all()),
              f"{name}: output not finite or of shape {tuple(y.shape)}")
        err = max_err(y, want)
        check(bool(torch.allclose(y, want, **TOL_LONG)),
              f"{name}: fifo-ring vs oracle err {err}")
        ca = a.compile(backend="cuda", mode="addressable")
        t0 = time.perf_counter()
        ya = counted(name, lambda: ca(x, TSTEPS, BLOCK))
        addr_s = time.perf_counter() - t0
        walls[name] = {"ring_stencil": fused_s, "addressable_step": addr_s}
        aerr = max_err(ya, want)
        check(bool(torch.allclose(ya, want, **TOL_LONG)),
              f"{name}: addressable vs oracle err {aerr}")
        check(close(y, ya), f"{name}: fifo-ring vs addressable err "
              f"{max_err(y, ya)}")
        say(f"phase 2 {name} {shape} T={TSTEPS}: fifo-ring err {err:.3g} "
            f"({fused_s:.3f} s host clock), addressable err {aerr:.3g} "
            f"({addr_s:.3f} s), fifo-ring vs addressable err "
            f"{max_err(y, ya):.3g}, |oracle| max "
            f"{float(want.abs().max()):.3g}")

    for name, want in VALIDATE.items():
        a = planned(name)
        v = counted(name, lambda: a.validate(backend="cuda")).validation
        check(v.backend == "cuda" and (v.replays, v.rejections) == want,
              f"{name}: validate gave {v.summary()}")
        say(f"phase 2 validate: {v.summary()}")
    a = analyze(get("jacobi-1d")).classify().size(pow2=True).plan()
    broken = next(p for p in a.plans if p.pattern_before != Pattern.FIFO.value
                  and not p.split)
    bad = dataclasses.replace(broken, lowering=FIFO_STREAM)
    wrong = dataclasses.replace(a, plans=tuple(
        bad if p.name == bad.name else p for p in a.plans))
    try:
        wrong.validate(backend="cuda")
    except ValidationError as e:
        say(f"phase 2 wrong plan rejected: {str(e).splitlines()[1].strip()}")
    else:
        raise AssertionError("a FIFO plan on a non-FIFO channel validated")
    total = {n: k.launches for n, k in kernels.items()}
    say(f"phase 2 launches: {json.dumps(total)}")
    for n, count in total.items():
        check(count > 0, f"kernel {n} never launched on the main path")
    for n in ("ring_stencil", "addressable_step", "replay"):
        for name in SIZES:
            check(launches.get((n, name), 0) > 0, f"{n} not run on {name}")

    # ---------------------------------------------------------- phase 3 --
    for name, (shape, steps, blocks) in SMALL.items():
        c = planned(name).compile(backend="cuda")
        x = on_card(shape)
        want = c.program.ref(x, steps)
        block = blocks[-1]
        check(close(c(x, steps, block), want), f"{name}: small run")
        for knob in ({"ring_depth": (steps + 1) // 2},
                     {"halo": 2 * c.program.radius - 1}):
            got = c(x, steps, block, **knob)
            check(not close(got, want), f"{name}: {knob} did not diverge")
            say(f"phase 3 {name} {knob}: diverges by {max_err(got, want):.3g}")

    # ---------------------------------------------------------- phase 4 --
    errs = {}
    for name, (shape, steps, blocks) in SMALL.items():
        p = cg.STENCIL_PROGRAMS[name]
        x = on_card(shape)
        for block in blocks:
            for depth, halo in ((steps + 1, 2), ((steps + 1) // 2, 2),
                                (steps + 1, 1)):
                got = cg.ring_stencil(x, p, steps, block, depth, halo)
                want = cg._ring_plain(x, p, steps, block, depth, halo)
                e = max_err(got, want)
                check(close(got, want), f"ring {name} block {block} depth "
                      f"{depth} halo {halo}: err {e}")
        got, want = cg.addressable_step(x, p), cg._addressable_plain(x, p)
        check(close(got, want), f"addressable {name}: {max_err(got, want)}")
    say("phase 4 small shapes: ring (block 1 and injections included) and "
        "addressable match their plain versions")
    events = {}
    for name, x in inputs.items():
        p = cg.STENCIL_PROGRAMS[name]
        got = cg.ring_stencil(x, p, STEPS, BLOCK, STEPS + 1, 2)
        want = cg._ring_plain(x, p, STEPS, BLOCK, STEPS + 1, 2)
        errs[("ring_stencil", name)] = max_err(got, want)
        check(close(got, want), f"ring {name} full size: "
              f"{errs[('ring_stencil', name)]}")
        got, want = cg.addressable_step(x, p), cg._addressable_plain(x, p)
        errs[("addressable_step", name)] = max_err(got, want)
        check(close(got, want), f"addressable {name} full size")
        a = planned(name)
        sizing = a.ctx.sizing(a.ppn)
        worst, lists = 0, []
        for ch in a.ppn.channels:
            trace = trace_channel(a.ppn, ch, sizing)
            if trace.num_edges == 0:
                continue
            ev = cb._build_events(trace)
            pad = cb._pow2(len(ev.kind)) - len(ev.kind)
            arrs = [np.concatenate([ev.kind, np.full(pad, cb._NOOP)]),
                    np.concatenate([ev.value, np.zeros(pad, np.int64)]),
                    np.concatenate([ev.slot, np.zeros(pad, np.int64)])]
            lists.append(([torch.from_numpy(v.astype(np.int32)).to(dev)
                           for v in arrs], cb._pow2(ev.needed)))
        for ts, ring in lists:
            for order_op in (cb._FIFO, cb._REGISTER, cb._REORDER):
                got = cb.replay_events(*ts, ring, order_op)
                want = cb._replay_plain(*ts, ring, order_op)
                worst = max(worst, int((got - want).abs().max()))
        errs[("replay", name)] = float(worst)
        check(worst == 0, f"replay {name}: kernel and plain version differ")
        events[name] = max(lists, key=lambda item: item[0][0].numel())
    say("phase 4 main-path shapes: every kernel matches its plain version")

    # ---------------------------------------------------------- phase 5 --
    conv_w = {
        "jacobi-1d": torch.tensor([1.0, 1.0, 1.0]) / 3.0,
        "jacobi-2d": torch.tensor([[0.0, 0.2, 0.0], [0.2, 0.2, 0.2],
                                   [0.0, 0.2, 0.0]]),
        "heat-3d": torch.zeros(3, 3, 3),
    }
    hw = conv_w["heat-3d"]
    hw[1, 1, 1] = 0.25
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        hw[idx] = 0.125
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
    rows = []
    for name, x in inputs.items():
        p = cg.STENCIL_PROGRAMS[name]
        cells = x.numel()
        w = conv_w[name].to(dev)[None, None]
        xin = x[None, None]
        fn = conv[x.dim()]
        lib_err = max_err(fn(xin, w, padding=1)[0, 0],
                          cg._addressable_plain(x, p))
        check(lib_err < 1e-4, f"{name}: conv yardstick err {lib_err}")
        traffic = hbm_traffic_model(cells, STEPS)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        d1, d2 = cg._inner_dims(x)
        out = torch.empty_like(x)
        scratch = cg.ring_scratch(x, BLOCK, STEPS + 1, 2)
        raw = {
            "ring_stencil": lambda: cuda_lib.RING_STENCIL(
                x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                p.cuda_kind, x.shape[0], d1, d2, STEPS, BLOCK, STEPS + 1, 2,
                stream),
            "addressable_step": lambda: cuda_lib.ADDRESSABLE_STEP(
                x.data_ptr(), out.data_ptr(), p.cuda_kind, x.shape[0], d1,
                d2, stream),
        }
        for kernel, kfn, pfn, lfn, nbytes, flops in (
                ("ring_stencil",
                 lambda: cg.ring_stencil(x, p, STEPS, BLOCK, STEPS + 1, 2),
                 lambda: cg._ring_plain(x, p, STEPS, BLOCK, STEPS + 1, 2),
                 None, traffic["fifo_bytes"],
                 STEPS * cells * FLOPS_PER_CELL[name]),
                ("addressable_step", lambda: cg.addressable_step(x, p),
                 lambda: cg._addressable_plain(x, p),
                 lambda: fn(xin, w, padding=1),
                 traffic["naive_bytes"] / STEPS,
                 cells * FLOPS_PER_CELL[name])):
            bound_s, bound_by = h100.roofline_seconds(nbytes, flops)
            rows.append({
                "name": f"{kernel}[{name}]", "route": "cuda",
                "source": SOURCES[kernel], "replaces": REPLACES[kernel],
                "launches": launches[(kernel, name)],
                "max_abs_err": errs[(kernel, name)],
                "ms": cuda_ms(kfn, 20),
                "device_ms": device_ms(raw[kernel], 5 if kernel ==
                                       "ring_stencil" else 200),
                "plain_ms": cuda_ms(pfn, 3),
                "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                "library_ms": None if lfn is None else cuda_ms(lfn, 20),
                "shape": list(x.shape), "steps": STEPS, "block": BLOCK})
        for kernel in ("ring_stencil", "addressable_step"):
            row = rows[-2 if kernel == "ring_stencil" else -1]
            busy = (row["device_ms"] * launches[(kernel, name)] / 1e3
                    / walls[name][kernel])
            say(f"phase 5 {name} {kernel} job T={TSTEPS}: "
                f"{walls[name][kernel]:.4f} s host clock, "
                f"{launches[(kernel, name)]} launches, device busy "
                f"{busy:.4f} of it")
        ts, ring = events[name]
        n_ev = ts[0].numel()
        ring_buf = torch.empty(ring, dtype=torch.int32, device=dev)
        out6 = torch.empty(6, dtype=torch.int32, device=dev)
        rows.append({
            "name": f"replay[{name}]", "route": "cuda",
            "source": SOURCES["replay"], "replaces": REPLACES["replay"],
            "launches": launches[("replay", name)],
            "max_abs_err": errs[("replay", name)],
            "ms": cuda_ms(lambda: cb.replay_events(*ts, ring, cb._FIFO), 20),
            "device_ms": device_ms(lambda: cuda_lib.REPLAY(
                *(t.data_ptr() for t in ts), n_ev, ring_buf.data_ptr(), ring,
                cb._FIFO, out6.data_ptr(), stream), 200),
            "plain_ms": cuda_ms(
                lambda: cb._replay_plain(*ts, ring, cb._FIFO), 3),
            "bound_ms": h100.roofline_seconds(3 * 4 * n_ev + 6 * 4, 0)[0]
            * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "events": n_ev, "ring_slots": ring})
    timing = cb.measure_compiled(planned("jacobi-1d").compile(), 4000,
                                 STEPS, BLOCK, repeats=5)
    say(f"phase 5 measure_compiled(jacobi-1d, 4000): {json.dumps(timing)}")
    for row in rows:
        say(f"phase 5 {row['name']}: {row['ms']:.4f} ms (device "
            f"{row['device_ms']}, plain "
            f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.5f} by "
            f"{row['bound_by']}, library {row['library_ms']})")
    say(f"total {time.perf_counter() - t_start:.1f} s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    say(smi.stdout.strip().splitlines()[0])
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
