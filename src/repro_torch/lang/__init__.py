"""Declarative kernel-authoring frontend (a copy of `repro.lang`'s builder,
registry check and command line).

    from repro_torch.lang import Nest

`Nest` builds loop-nest programs with operator-overloaded affine index
expressions, compiles them to the polyhedral core's `Kernel`/`KernelCase`
(automatic 2d+1 schedules from program order, derived load/store boundary
processes, per-statement tilings), and validates specs with actionable
diagnostics (`SpecError`).  `analyze()` / `sweep()` and the kernel registry
accept `Nest` programs directly via the ``__kernelcase__()`` protocol.

``python -m repro_torch.lang --check-registry`` validates every registered
kernel spec (CI runs it before any analysis timing section).
"""
from .builder import (AccessRef, AffExpr, ArrayRef, Nest, NonAffine,
                      SpecError)
from .check import check_registry

__all__ = ["AccessRef", "AffExpr", "ArrayRef", "Nest", "NonAffine",
           "SpecError", "check_registry"]
