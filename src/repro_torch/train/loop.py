"""The fault-tolerant training loop: data pipeline → train step →
watchdog/metrics → async checkpoints → preemption-safe exit → crash replay.
`repro_torch.examples.quickstart` and the tests drive it end to end on the
CPU (``device="cpu"``); it runs on the card where ``device`` is None.

The port of `repro.train.loop`, in the reference's order, with two
differences that make a resumed or replayed run exact:

* Checkpoints are named by the global step (the restored step plus the
  steps of this call).  The reference names them by the call's own count,
  so a resumed run's first save collides with (or hides behind) the
  checkpoints it resumed from.
* The guarded step takes its batch from the pipeline itself, so a retry
  after a restore reads the batch of the restored step; the count of steps
  and the losses rewind with it (`TrainReport.losses` holds one loss per
  step of the run that stands).  The reference retries with the batch that
  failed and counts on.

With rules on a DeviceMesh every rank runs this loop in step: the state is
drawn whole and laid out by the bundle's specs (or restored onto them),
the pipeline lays each batch out by the batch spec, every rank joins each
checkpoint's gathers, and a fault injected at a step fails on every rank,
so the restore and replay are collective too.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..checkpoint import CheckpointManager
from ..data.pipeline import DataPipeline
from ..models.common import resolve_device
from ..models.model import Model
from ..models.sharding import Rules, is_dtensor
from ..tree import tree_map
from .ft import PreemptionGuard, StepWatchdog, retrying
from .step import init_train_state, make_abstract_train_state, make_train_step

log = logging.getLogger("repro_torch.train")


@dataclass
class TrainReport:
    steps_run: int
    final_loss: float
    losses: list
    stragglers: list
    preempted: bool
    restored_from: Optional[int]


def train(model: Model, rules: Rules, *, steps: int, ckpt_dir: str,
          seed: int = 0, ckpt_every: int = 50, lr: float = 3e-4,
          fail_at: Optional[int] = None, log_every: int = 10,
          device=None) -> TrainReport:
    """Run (or resume) training for `steps` optimizer steps on ``device``
    (the card where None).

    `fail_at` injects a fault at that (global) step, once (tests use it to
    exercise the restore-and-replay path).
    """
    dev = resolve_device(device)
    bundle = make_train_step(model, rules, lr=lr)
    mgr = CheckpointManager(ckpt_dir)
    guard = PreemptionGuard()
    watchdog = StepWatchdog()
    like = make_abstract_train_state(model)
    layout = {}
    if rules.on_mesh:
        layout = {"mesh": rules.mesh, "placements": tree_map(
            rules.spec_placements, bundle.state_specs)}

    # ----- state: fresh or restored
    restored_from = mgr.latest_step()
    if restored_from is not None:
        state, extra = mgr.restore(restored_from, like, dev, **layout)
        start_step = int(extra.get("data_step", restored_from))
        log.info("restored from step %s", restored_from)
    else:
        state = init_train_state(model, seed, dev, rules)
        start_step = 0

    cfg = model.cfg
    # batch geometry comes from the caller via pipeline; default smoke sizes
    B, S = 8, 128
    extra_feats = {}
    if cfg.family == "encdec":
        extra_feats["frames"] = ((B, S, cfg.d_model), np.float32)
    pipe = DataPipeline(dev, batch=B, seq=S, vocab=cfg.vocab_size, seed=seed,
                        start_step=start_step, extra=extra_feats, rules=rules)

    losses = []
    box = {"state": state, "i": 0}

    def restore_last():
        mgr.wait()                       # a save may still be in flight
        s = mgr.latest_step()
        if s is None:
            box["state"] = init_train_state(model, seed, dev, rules)
            pipe.step = 0
        else:
            box["state"], extra = mgr.restore(s, like, dev, **layout)
            pipe.step = int(extra.get("data_step", s))
        box["i"] = max(pipe.step - start_step, 0)
        del losses[box["i"]:]

    fail_box = {"at": fail_at}

    def one_step():
        batch = next(pipe)
        if fail_box["at"] is not None and pipe.step - 1 == fail_box["at"]:
            fail_box["at"] = None
            raise RuntimeError("injected fault")
        box["state"], metrics = bundle.step_fn(box["state"], batch)
        return metrics

    guarded_step = retrying(one_step, restore_last)

    preempted = False
    while box["i"] < steps:
        t0 = time.time()
        metrics = guarded_step()
        loss = metrics["loss"]
        loss = float(loss.full_tensor() if is_dtensor(loss) else loss)
        i = box["i"]
        losses.append(loss)
        watchdog.observe(i, time.time() - t0)
        if i % log_every == 0:
            log.info("step %d loss %.4f (%.2fs)", i, loss, time.time() - t0)
        i = box["i"] = i + 1
        done = start_step + i
        if done % ckpt_every == 0 or guard.should_exit or i == steps:
            mgr.save(done, box["state"], extra={"data_step": pipe.step},
                     blocking=(i == steps or guard.should_exit))
        if guard.should_exit:
            preempted = True
            break
    pipe.close()
    mgr.wait()
    guard.restore()
    return TrainReport(box["i"], losses[-1] if losses else float("nan"),
                       losses, watchdog.stragglers, preempted, restored_from)
