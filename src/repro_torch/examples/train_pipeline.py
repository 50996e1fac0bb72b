"""Pipeline-parallel training with planner-derived FIFO channels.

    PYTHONPATH=src python -m repro_torch.examples.train_pipeline [--device cpu|cuda]

The communication planner classifies the inter-stage channels of the chosen
schedule with the paper's algorithm and emits `ChannelPlan` records; the
runtime selects the collective implementation from those records through the
shared lowering registry (`repro_torch.runtime`) and trains a stacked-MLP
model across 4 pipeline stages held by one `LocalGroup` on the device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.comm import (LocalGroup, PipelineSpec, analyze_pipeline,
                              pipeline_train_step, plan_report,
                              ring_lowering, stage_params)

S, M, MB, D = 4, 8, 4, 32


def stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def loss_head(h, tgt):
    return torch.mean((h - tgt) ** 2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    group = LocalGroup(S, args.device)

    print("=== planner verdicts (paper's classifier on the schedule) ===")
    _, plans = analyze_pipeline(PipelineSpec(stages=S, microbatches=M))
    print(plan_report(plans))
    print(f"→ registry selects {ring_lowering(plans)!r} for the "
          f"inter-stage ring\n")

    rng = np.random.default_rng(0)
    params = stage_params({
        "w": (0.3 * rng.standard_normal((S, D, D))).astype(np.float32),
        "b": np.zeros((S, D), np.float32)}, group)
    xs = torch.from_numpy(rng.standard_normal((M, MB, D)).astype(
        np.float32)).to(group.device)
    tgt = torch.from_numpy((0.1 * rng.standard_normal((M, MB, D))).astype(
        np.float32)).to(group.device)

    step = pipeline_train_step(stage_fn, loss_head, group, plans=plans,
                               lr=0.05)
    first = None
    for i in range(30):
        params, loss = step(params, xs, tgt)
        first = float(loss) if first is None else first
        if i % 5 == 0:
            print(f"step {i:3d} pipeline loss {float(loss):.5f}")
    if not float(loss) < first:
        raise RuntimeError(f"the loss did not decrease: {first} -> "
                           f"{float(loss)}")
    print(f"done — loss decreased across {S} pipeline stages on "
          f"{group.device}")

    # same flag, different backend: a backend-qualified lowering name routes
    # the ring step through the cuda backend's implementations instead
    qualified = f"cuda:{ring_lowering(plans)}"
    step_q = pipeline_train_step(stage_fn, loss_head, group,
                                 lowering=qualified, lr=0.05)
    _, loss_q = step_q(params, xs, tgt)
    print(f"one step via lowering={qualified!r}: loss {float(loss_q):.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
