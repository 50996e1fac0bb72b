"""The GLA time-mix kernel's three phases, timed apart.

Times kernel 6 (``csrc/gla_timemix.cu``, its C entry point) at
rwkv6-1.6b's width (H = 32, hd = 64) and at the same model width in heads
of 128 (H = 16), B = 1, S = 4096, chunk 64, in float32 and bf16, decays
drawn at scale 1.0: each phase alone (A, the chunks' state increments; B,
the state scan; C, the outputs), the whole call's three launches, each
queued back to back and timed with CUDA events (the device's time), the
wrapper's call, and the plain version's call.  Each output is first held
against the plain version (2e-3 in float32, 2e-2 in bf16).  Needs a CUDA
device and ``nvcc``; without a device it exits 2.

    PYTHONPATH=src python -m repro_torch.bench.gla_phases [--seed N]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from . import cuda_ms
from .ring_sweep import launch_ms

#: (name, B, S, H, hd, chunk)
SHAPES = (("rwkv6-1.6b", 1, 4096, 32, 64, 64),
          ("hd=128", 1, 4096, 16, 128, 64))
DTYPES = ("float32", "bfloat16")
#: the C entry's phase mask: A, B, C and the whole call
PHASES = {"A": 1, "B": 2, "C": 4, "all": 7}
TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def rows(seed: int = 0):
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.gla_timemix import kernel as gla

    rng = np.random.default_rng(seed)
    out = []
    for (name, B, S, H, hd, C), dname in (
            (shape, d) for shape in SHAPES for d in DTYPES):
        dt = getattr(torch, dname)
        arrs = [rng.normal(size=(B, S, H, hd)) for _ in range(3)]
        arrs.append(-np.exp(rng.normal(size=(B, S, H, hd))))
        arrs.append(rng.normal(size=(H, hd)))
        ins = [torch.from_numpy(a.astype(np.float32)).to("cuda", dt)
               for a in arrs]
        got = gla.gla_timemix(*ins, chunk=C)
        want = gla._gla_timemix_plain(*ins, chunk=C)
        err = float((got.float() - want.float()).abs().max())
        tol = TOL[dname]
        if not (bool(torch.isfinite(got).all()) and torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol)):
            raise AssertionError(f"{name} {dname}: err {err}")
        del want
        o = torch.empty_like(got)
        ws = torch.empty(gla.workspace_floats(B, S, H, hd, C),
                         device="cuda")
        stream = cuda_lib.raw_stream(o.device)
        row = {"name": name, "dtype": dname, "shape": [B, S, H, hd],
               "chunk": C, "max_abs_err": err}
        # each phase alone reads what the one before left in the
        # workspace; the values do not change the time
        for phase, mask in PHASES.items():
            row[f"device_ms_{phase}"] = launch_ms(
                lambda: cuda_lib.GLA_TIMEMIX(
                    *(t.data_ptr() for t in ins), o.data_ptr(),
                    ws.data_ptr(), B, S, H, hd, C, gla._DTYPES[dt], mask,
                    stream, launches=0), 20)
        row["call_ms"] = cuda_ms(lambda: gla.gla_timemix(*ins, chunk=C), 20)
        row["plain_ms"] = cuda_ms(
            lambda: gla._gla_timemix_plain(*ins, chunk=C), 3)
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gla_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"device: {smi.stdout.strip().splitlines()[0]}")
    for row in rows(args.seed):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
