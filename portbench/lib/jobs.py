"""Closed-loop jobs: one client sends the next job when the last has ended.
The seeds of the jobs' inputs, the window of back-to-back jobs, and the
sample of finished jobs held for the check."""
from __future__ import annotations

import hashlib
import random
import time
from typing import Callable, List, Tuple


def job_seed(seed: int, index: int) -> int:
    """The generator seed of job ``index`` of a run seeded ``seed``: 63 bits
    of a hash of both, so every seed of any size gives its own inputs and
    the same seed the same ones."""
    digest = hashlib.blake2b(f"{seed}/{index}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


class Reservoir:
    """A uniform sample of at most ``size`` of the jobs offered, drawn from
    ``seed`` (reservoir sampling): only the sampled outputs are held."""

    def __init__(self, size: int, seed: int) -> None:
        self.size = size
        self.rng = random.Random(f"portbench.sample/{seed}")
        self.seen = 0
        self.kept: List[Tuple[int, object]] = []

    def offer(self, index: int, output) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((index, output))
            return
        slot = self.rng.randrange(self.seen)
        if slot < self.size:
            self.kept[slot] = (index, output)


def closed_loop(job: Callable[[int], object], seconds: float,
                keep: Reservoir) -> Tuple[int, float]:
    """Whole jobs ``job(0)``, ``job(1)``, … back to back until ``seconds``
    have passed (the last job ends past the mark).  Returns the jobs run
    and the host seconds they took."""
    start, n = time.perf_counter(), 0
    while True:
        keep.offer(n, job(n))
        n += 1
        elapsed = time.perf_counter() - start
        if elapsed >= seconds:
            return n, elapsed
