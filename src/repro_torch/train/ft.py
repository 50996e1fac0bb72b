"""Fault-tolerance machinery: preemption handling, step retry, straggler
watchdog, elastic restart.

A copy of `repro.train.ft` (host code, no jax in it).

On a real fleet these hooks are driven by the cluster scheduler (SIGTERM
before eviction, per-host heartbeats); the control logic is implemented and
unit-tested here, hardware-independent:

* `PreemptionGuard` — converts SIGTERM/SIGINT into a "checkpoint and exit
  cleanly at the next step boundary" flag.
* `StepWatchdog` — EWMA of step wall-times; flags stragglers (steps slower
  than `threshold ×` the moving average).  On a fleet the flag triggers
  re-slicing / hot-spare swap; here it is surfaced in metrics and logs.
* `retrying` — wraps the step function: on failure, restores the last
  checkpoint and replays (the data pipeline is stateless-resumable, so
  replay is exact).
* elastic restart = CheckpointManager.restore onto another device (tested
  in tests/test_torch_checkpoint.py): checkpoints store logical arrays.
"""
from __future__ import annotations

import logging
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

log = logging.getLogger("repro_torch.ft")


class PreemptionGuard:
    """Usable as a context manager: handlers are installed on construction
    and restored on ``__exit__``, so a training loop can write

        with PreemptionGuard() as guard:
            for step in steps:
                ...
                if guard.should_exit:
                    break
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._old = {}
        for s in signals:
            try:
                self._old[s] = signal.signal(s, self._handler)
            except ValueError:          # not main thread (tests)
                pass

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received; will checkpoint and exit",
                    signum)
        self._requested = True

    @property
    def should_exit(self) -> bool:
        return self._requested

    def restore(self):
        for s, h in self._old.items():
            signal.signal(s, h)
        self._old = {}

    def __enter__(self) -> "PreemptionGuard":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.restore()


@dataclass
class StepWatchdog:
    threshold: float = 2.5
    ewma_alpha: float = 0.1
    _ewma: Optional[float] = None
    stragglers: List[int] = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        if self._ewma is None:
            self._ewma = seconds
            return False
        is_slow = seconds > self.threshold * self._ewma
        self._ewma = (1 - self.ewma_alpha) * self._ewma + self.ewma_alpha * seconds
        if is_slow:
            self.stragglers.append(step)
            log.warning("straggler: step %d took %.3fs (ewma %.3fs) — on a "
                        "fleet this triggers re-slicing", step, seconds,
                        self._ewma)
        return is_slow


def retrying(fn: Callable, restore_fn: Callable, max_retries: int = 3,
             backoff: float = 0.0, max_backoff: float = 30.0,
             sleep: Callable[[float], None] = time.sleep):
    """Run fn(); on exception call restore_fn() and retry (transient-fault
    recovery: lost host, flaky interconnect, preempted worker).

    The retry budget is a hard cap — attempt ``max_retries + 1`` re-raises.
    With ``backoff > 0`` the wait before retry k is
    ``min(backoff * 2**(k-1), max_backoff)`` (bounded exponential backoff;
    ``sleep`` is injectable so tests never actually wait)."""
    def wrapped(*a, **kw):
        for attempt in range(max_retries + 1):
            try:
                return fn(*a, **kw)
            except KeyboardInterrupt:
                raise
            except Exception as e:
                if attempt == max_retries:
                    log.error("step failed (%s); retry budget (%d) "
                              "exhausted", e, max_retries)
                    raise
                wait = min(backoff * (2 ** attempt), max_backoff) \
                    if backoff > 0 else 0.0
                log.warning("step failed (%s); restoring and retrying "
                            "(%d/%d, backoff %.2fs)", e, attempt + 1,
                            max_retries, wait)
                restore_fn()
                if wait > 0:
                    sleep(wait)
    return wrapped
