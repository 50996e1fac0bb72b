"""Frontend-agnostic kernel registry.

Factories register under a name and may return ANY authoring frontend's
product: a polybench ``KernelCase``, a ``repro_torch.lang`` builder program, or any
object implementing the ``__kernelcase__()`` protocol (returns a
``KernelCase``-shaped object with ``.kernel`` / ``.tilings`` / ``.compute``).
``get`` normalizes through the protocol, so consumers (benchmarks, sweeps,
tests) never care which frontend authored a kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

from .dataflow import Kernel
from .tiling import Tiling


@dataclass
class KernelCase:
    """The frontend-neutral unit every registry entry resolves to: a compiled
    kernel, the tiling assignment of the experiment, and the compute-process
    names the paper's tables count channels between.  (Historically defined
    in `polybench`, which still re-exports it.)"""

    kernel: Kernel
    tilings: Dict[str, Tiling]
    compute: Tuple[str, ...]
    notes: str = ""


_REGISTRY: Dict[str, Callable[[int], Any]] = {}


def register(name: str):
    """Decorator: register a kernel factory ``fn(scale) -> spec`` where
    ``spec`` is a ``KernelCase`` or anything with ``__kernelcase__()``."""
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def kernel_names() -> List[str]:
    return list(_REGISTRY)


def resolve_case(spec: Any):
    """Normalize a frontend product into a ``KernelCase``-shaped object."""
    if hasattr(spec, "__kernelcase__"):
        return spec.__kernelcase__()
    return spec


def get(name: str, scale: int = 1):
    """Build the registered kernel at ``scale`` as a ``KernelCase``."""
    return resolve_case(_REGISTRY[name](scale))
