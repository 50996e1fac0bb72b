"""The channel-lowering IR: one vocabulary, one verdict table, one registry.

`Analysis.plan()` emits backend-neutral `ChannelPlan` records whose
``lowering`` field is drawn from the vocabulary below.  Everything that turns
a classification verdict into an implementation goes through this module:

* :data:`PATTERN_LOWERING` — THE verdict → lowering table.  The planner, the
  comm backend and the docs all read it from here; nothing else may encode
  the mapping.
* :class:`ChannelLowering` — the interface a backend implements per lowering.
* :class:`Backend` / :func:`backend` — the registry.  Four backends ship:
  ``"reference"`` (the trace-driven simulator, `runtime/simulator.py`),
  ``"cuda"`` (hand-written CUDA ring kernels, `runtime/cuda_backend.py`),
  ``"torch"`` (the pipeline ring's collectives on a stage group,
  `runtime/torch_backend.py`) and ``"selftimed"`` (per-event queue
  machines + the dataflow-driven engine on the host,
  `runtime/selftimed/`); all are loaded lazily on
  first lookup so importing the analysis core never pulls in torch, and
  the ``"cuda"`` backend registers on a host with no GPU (its kernels build
  and load at first launch).  A backend may additionally attach a
  whole-PPN ``compile`` hook (the cuda and selftimed backends do —
  `Analysis.compile(backend=...)`).

This module deliberately imports nothing from `repro_torch.core`: the table is
keyed on the classifier's pattern *values* (the `Pattern` enum is str-valued)
so `core/analysis.py` can import it without a cycle.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Iterator, Optional, Tuple

# ------------------------------------------------------------- vocabulary --
# Lowering names, cheapest first.  These strings ARE the IR: they appear in
# `ChannelPlan.lowering`, in `AnalysisReport` JSON, and as registry keys.

FIFO_STREAM = "ppermute"                      # FIFO neighbor stream
DEPTH_SPLIT = "ppermute(depth-split)"         # paper SPLIT, all parts FIFO
CHUNK_SPLIT = "ppermute(chunk-split)"         # per-tile-pair split succeeded
BROADCAST_REGISTER = "ppermute+register"      # in-order, multicast consumer
REORDER_BUFFER = "reorder-buffer"             # out-of-order; addressable

LOWERINGS: Tuple[str, ...] = (FIFO_STREAM, DEPTH_SPLIT, CHUNK_SPLIT,
                              BROADCAST_REGISTER, REORDER_BUFFER)

#: lowerings that stream values in production order (a recovered-FIFO split
#: part is still a stream; the registry treats the split variants as
#: FIFO_STREAM applied per part)
STREAM_LOWERINGS: Tuple[str, ...] = (FIFO_STREAM, DEPTH_SPLIT, CHUNK_SPLIT)

# THE verdict → lowering table (single source of truth).  Keys are
# `repro_torch.core.patterns.Pattern` values.
PATTERN_LOWERING: Dict[str, str] = {
    "fifo": FIFO_STREAM,
    "in-order+mult": BROADCAST_REGISTER,
    "out-of-order+unicity": REORDER_BUFFER,
    "out-of-order": REORDER_BUFFER,
}


def lowering_for_pattern(pattern) -> str:
    """Lowering a channel with this verdict gets when it is not split.
    Accepts a `Pattern` or its string value."""
    return PATTERN_LOWERING[getattr(pattern, "value", pattern)]


def split_lowering(label: str) -> str:
    """Lowering name of a successful split recovery (``label`` is the
    splitter tag: ``"depth-split"`` or ``"chunk-split"``)."""
    name = f"ppermute({label})"
    if name not in LOWERINGS:
        raise KeyError(f"unknown split label {label!r}")
    return name


def is_stream(lowering: str) -> bool:
    return lowering in STREAM_LOWERINGS


def is_cheap(lowering: str) -> bool:
    """True for every lowering served by a neighbor stream (the broadcast
    register rides the same link); only the addressable reorder buffer —
    the lowering the paper's algorithm exists to avoid — is expensive."""
    return lowering != REORDER_BUFFER


#: THE degradation ladder (single source of truth, like PATTERN_LOWERING but
#: for the runtime direction): when a guard observes a cheap lowering's
#: ordering contract violated live, this is the lowering it hot-swaps to.
#: Every cheap entry degrades straight to the addressable reorder buffer —
#: the one lowering whose semantics need no ordering assumption — and the
#: reorder buffer has nowhere further to fall (absent from the table).
DEGRADED_LOWERING: Dict[str, str] = {
    FIFO_STREAM: REORDER_BUFFER,
    DEPTH_SPLIT: REORDER_BUFFER,
    CHUNK_SPLIT: REORDER_BUFFER,
    BROADCAST_REGISTER: REORDER_BUFFER,
}


def degrade(lowering: str) -> str:
    """The lowering a runtime guard falls back to when ``lowering``'s
    ordering contract is violated; raises `KeyError` for lowerings that are
    already fully addressable (nothing weaker to assume)."""
    try:
        return DEGRADED_LOWERING[lowering]
    except KeyError:
        raise KeyError(f"lowering {lowering!r} has no degraded form — it "
                       f"already makes no ordering assumption") from None


# --------------------------------------------------------------- interface --

class ChannelLowering:
    """One lowering's implementation in one backend.

    Subclasses declare which vocabulary entries they implement via the
    registry decorator; what "implement" means is backend-specific —
    the reference backend replays traces (`run(trace) -> peak occupancy`,
    raising on a semantics violation), the torch backend builds collective
    step functions (`step(h, group, stage, n) -> h_next`), and the cuda
    backend does both.
    """

    #: primary lowering name (set by `Backend.register`)
    lowering: str = ""

    def describe(self) -> str:
        return f"{type(self).__name__}[{self.lowering}]"


class BackendUnavailable(ImportError):
    """A lazily-registered backend's module failed to import.  Carries the
    backend name so a missing optional dependency fails loudly as "backend
    X is unavailable" instead of a bare `ModuleNotFoundError` three imports
    deep."""

    def __init__(self, name: str, module: str, reason: BaseException):
        super().__init__(
            f"backend {name!r} is unavailable: importing {module!r} failed "
            f"({type(reason).__name__}: {reason})")
        self.backend = name
        self.module = module
        self.reason = reason


class Backend:
    """A named set of `ChannelLowering` implementations, one per vocabulary
    entry.  Instances live in the module-level registry (`backend()`).

    A backend may also attach a whole-PPN compiler via :attr:`compile` —
    a callable ``compile(analysis, **options) -> executable`` that turns a
    planned `Analysis` into runnable kernels (`Analysis.compile` resolves
    through this hook)."""

    def __init__(self, name: str):
        self.name = name
        self._impl: Dict[str, Callable[[], ChannelLowering]] = {}
        self.compile: Optional[Callable] = None

    def register(self, *lowerings: str):
        """Class decorator: register ``cls`` as this backend's implementation
        of each named lowering."""
        unknown = [l for l in lowerings if l not in LOWERINGS]
        if unknown:
            raise KeyError(f"unknown lowering(s) {unknown} — the vocabulary "
                           f"is {list(LOWERINGS)}")

        def deco(cls):
            for l in lowerings:
                self._impl[l] = cls
            if not getattr(cls, "lowering", ""):
                cls.lowering = lowerings[0]
            return cls

        return deco

    def supports(self, lowering: str) -> bool:
        return lowering in self._impl

    def implementation(self, lowering: str) -> ChannelLowering:
        """Instantiate this backend's implementation of ``lowering``."""
        try:
            cls = self._impl[lowering]
        except KeyError:
            raise KeyError(
                f"backend {self.name!r} implements no lowering "
                f"{lowering!r} (has: {sorted(self._impl)})") from None
        inst = cls()
        inst.lowering = lowering
        return inst

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._impl))


_REGISTRY: Dict[str, Backend] = {}

#: backends resolved on first use — keeps `import repro_torch.core` torch-free
_LAZY_BACKENDS: Dict[str, str] = {
    "reference": "repro_torch.runtime.simulator",
    "cuda": "repro_torch.runtime.cuda_backend",
    "torch": "repro_torch.runtime.torch_backend",
    "selftimed": "repro_torch.runtime.selftimed",
}


def register_backend(name: str) -> Backend:
    """The backend named ``name``, created empty if absent (idempotent —
    backend modules call this at import time to attach implementations)."""
    if name not in _REGISTRY:
        _REGISTRY[name] = Backend(name)
    return _REGISTRY[name]


def backend(name: str) -> Backend:
    """Look up a backend, importing its module on first use.  A lazy module
    that fails to import raises `BackendUnavailable` naming the backend."""
    got = _REGISTRY.get(name)
    if got is not None and got._impl:
        return got
    module = _LAZY_BACKENDS.get(name)
    if module is not None:
        try:
            importlib.import_module(module)
        except Exception as e:                # pragma: no cover - env-specific
            raise BackendUnavailable(name, module, e) from e
    got = _REGISTRY.get(name)
    if got is None:
        raise KeyError(f"no backend {name!r} "
                       f"(known: {sorted(set(_REGISTRY) | set(_LAZY_BACKENDS))})")
    return got


def backend_names() -> Tuple[str, ...]:
    return tuple(sorted(set(_REGISTRY) | set(_LAZY_BACKENDS)))


def available_backends() -> Dict[str, str]:
    """Import every registered backend and report availability: name →
    ``"ok"`` or the reason it cannot load.  Surfaced in
    ``python -m benchmarks.run --smoke`` so a broken lazy import fails
    loudly with the backend's name, not a bare traceback on first use."""
    out: Dict[str, str] = {}
    for name in backend_names():
        try:
            b = backend(name)
            n = sum(1 for _ in b)
            extra = "+compile" if b.compile is not None else ""
            out[name] = f"ok ({n} lowerings{extra})"
        except BackendUnavailable as e:
            out[name] = f"unavailable: {e.reason!r}"
        except Exception as e:                # pragma: no cover - defensive
            out[name] = f"broken: {type(e).__name__}: {e}"
    return out
