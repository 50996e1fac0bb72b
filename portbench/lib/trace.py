"""Whole jobs under `torch.profiler`, and the reduction of the device trace
to what the per-layer metrics and the result's ``breakdown`` read: the
device's busy time over the traced window, time and launches by kernel
name, and the idle gaps by what the host was doing."""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

#: the harness's span around the traced jobs: the traced window
WINDOW = "portbench.window"
#: idle gaps labelled one by one, the longest first (the rest are summed)
LABELLED_GAPS = 256
#: entries of each list in ``breakdown``
BREAKDOWN = 10


@dataclass
class TraceSummary:
    """What one traced window shows.  Seconds throughout."""

    jobs: int                       # whole jobs traced
    wall_s: float                   # host clock over those jobs
    window_s: float                 # the traced window on the trace's clock
    busy_s: float                   # union of device operations in it
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def mean_job_s(self) -> float:
        return self.wall_s / self.jobs

    def kernel_time(self, patterns: Sequence[str]) -> Tuple[int, float]:
        """Launches and device seconds of the kernels whose name holds one
        of ``patterns``."""
        count, total = 0, 0.0
        for name, (n, s) in self.kernels.items():
            if any(p in name for p in patterns):
                count, total = count + n, total + s
        return count, total


#: longest kernel name a breakdown keeps (template names run to thousands)
NAME_CHARS = 200


def _is_device(event) -> bool:
    return str(event.device_type()).rsplit(".", 1)[-1] != "CPU"


def _is_annotation(event) -> bool:
    """A span the harness marked, not an operation: its device-side copy
    spans the whole traced window."""
    marked = getattr(event, "is_user_annotation", None)
    return event.name() == WINDOW or (marked is not None and marked())


def profile_jobs(job: Callable[[int], object], min_seconds: float,
                 min_jobs: int, cuda: bool):
    """Run ``job(0)``, ``job(1)``, … under the profiler until at least
    ``min_jobs`` whole jobs and ``min_seconds`` have passed.  Returns the
    last job's result and the `TraceSummary`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            t0, n = time.perf_counter(), 0
            while True:
                out = job(n)
                n += 1
                if n >= min_jobs and time.perf_counter() - t0 >= min_seconds:
                    break
            wall = time.perf_counter() - t0
    return out, reduce_events(prof.profiler.kineto_results.events(), n, wall)


def reduce_events(events, jobs: int, wall_s: float) -> TraceSummary:
    """The `TraceSummary` of kineto ``events`` (``start_ns``, ``end_ns``,
    ``name``, ``device_type``) whose host side holds one `WINDOW` span."""
    host, device = [], []
    window = None
    for e in events:
        span = (e.start_ns(), e.end_ns(), e.name())
        if _is_device(e):
            if span[1] > span[0] and not _is_annotation(e):
                device.append(span)
        elif span[2] == WINDOW:
            window = span
        else:
            host.append(span)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = window[0], window[1]
    kernels: Dict[str, List] = defaultdict(lambda: [0, 0.0])
    for s, e, name in device:
        kernels[name][0] += 1
        kernels[name][1] += (e - s) * 1e-9
    clipped = sorted((max(s, w0), min(e, w1)) for s, e, _ in device
                     if e > w0 and s < w1)
    busy, gaps, cursor = 0, [], w0
    for s, e in clipped:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < w1:
        gaps.append((cursor, w1))
    ops = sorted(((name[:NAME_CHARS], s) for name, (_, s) in kernels.items()),
                 key=lambda t: -t[1])[:BREAKDOWN]
    return TraceSummary(
        jobs=jobs, wall_s=wall_s, window_s=(w1 - w0) * 1e-9,
        busy_s=busy * 1e-9,
        kernels={k: (n, s) for k, (n, s) in kernels.items()},
        device_ops=ops, idle_gaps=_label_gaps(gaps, host))


def _label_gaps(gaps: List[Tuple[int, int]], host: List[Tuple[int, int, str]]
                ) -> List[Tuple[str, float]]:
    """Idle seconds by what the host was doing: the `LABELLED_GAPS`
    longest gaps each named by the innermost host event (the latest to
    start) that spans its middle, summed by name; the shorter gaps summed
    as one entry."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    starts = np.array([h[0] for h in host], dtype=np.int64)
    ends = np.array([h[1] for h in host], dtype=np.int64)
    by_name: Dict[str, float] = defaultdict(float)
    for s, e in gaps[:LABELLED_GAPS]:
        mid = (s + e) // 2
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = ("no host event" if inside.size == 0
                else host[inside[np.argmax(starts[inside])]][2][:NAME_CHARS])
        by_name[name] += (e - s) * 1e-9
    out = sorted(by_name.items(), key=lambda t: -t[1])[:BREAKDOWN - 1]
    rest = gaps[LABELLED_GAPS:]
    if rest:
        out.append((f"{len(rest)} shorter gaps",
                    sum(e - s for s, e in rest) * 1e-9))
    return out
