"""Whole jobs under `torch.profiler`, as `lib.trace.profile_jobs` runs them,
and besides the trace's `TraceSummary` the time under the program's own
profiler spans (``torch.profiler.record_function`` in the program): each
span's count, its host seconds, and the device seconds of the operations
launched inside it.

An operation on the device is placed at the host time of the call that
launched it: the CUDA runtime or driver call with its correlation id, or,
where the trace holds none, the operator it is linked to.  It counts to
every span of a wanted name that holds that time (a span inside another
counts to both)."""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, Sequence

from . import trace


def _is_launch(event) -> bool:
    """A host call into the CUDA runtime (``cuda…``) or driver (``cu…``);
    operators are ``aten::…``, spans the program's names."""
    return event.name().startswith("cu")


def profile_spans(job: Callable[[int], object], min_seconds: float,
                  min_jobs: int, cuda: bool, names: Sequence[str]):
    """Run ``job(0)``, ``job(1)``, … under the profiler until at least
    ``min_jobs`` whole jobs and ``min_seconds`` have passed.  Returns the
    last job's result, the `TraceSummary` and `span_times` of ``names``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW):
            t0, n = time.perf_counter(), 0
            while True:
                out = job(n)
                n += 1
                if n >= min_jobs and time.perf_counter() - t0 >= min_seconds:
                    break
            wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    return (out, trace.reduce_events(events, n, wall),
            span_times(events, names))


def span_times(events, names: Sequence[str]) -> Dict[str, dict]:
    """``{name: {"count", "host_s", "device_s"}}`` for each of ``names``,
    and under ``"device"`` the device seconds of every operation and of
    those placed in no wanted span (``"outside_s"``).  Seconds throughout.
    """
    spans = {name: [] for name in names}
    launched_at, op_at, device = {}, {}, []
    for e in events:
        if trace._is_device(e):
            # a span's copy on the device's timeline is no operation
            if e.end_ns() > e.start_ns() and not trace._is_annotation(e) \
                    and e.name() not in spans:
                device.append(e)
        elif _is_launch(e):
            launched_at[e.correlation_id()] = e.start_ns()
        else:
            if e.name() in spans:
                spans[e.name()].append((e.start_ns(), e.end_ns()))
            op_at[e.correlation_id()] = e.start_ns()
    index = {}
    for name, found in spans.items():
        found.sort()
        index[name] = ([s for s, _ in found], [e for _, e in found])
    device_s = defaultdict(float)
    total = outside = 0.0
    for e in device:
        seconds = (e.end_ns() - e.start_ns()) * 1e-9
        total += seconds
        at = launched_at.get(e.correlation_id(),
                             op_at.get(e.linked_correlation_id()))
        inside = False
        if at is not None:
            for name, (starts, ends) in index.items():
                i = bisect.bisect_right(starts, at) - 1
                if i >= 0 and at <= ends[i]:
                    device_s[name] += seconds
                    inside = True
        if not inside:
            outside += seconds
    out = {name: {"count": len(found),
                  "host_s": sum(e - s for s, e in found) * 1e-9,
                  "device_s": device_s[name]}
           for name, found in spans.items()}
    out["device"] = {"count": len(device), "host_s": 0.0, "device_s": total,
                     "outside_s": outside}
    return out
