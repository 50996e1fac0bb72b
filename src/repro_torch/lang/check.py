"""Registry-wide spec validation — the fail-fast gate CI runs first.

Every registered kernel factory is built (a `repro_torch.lang` program compiles
and validates here; `SpecError` diagnostics become failures) and the
resulting case is sanity-checked frontend-agnostically: compute names and
tiling targets must be real statements, tiling normals must match statement
dimensionality.  Malformed specs fail HERE, with spec-level diagnostics,
before any analysis or benchmark timing section touches them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .builder import SpecError


def check_case(name: str, case) -> List[str]:
    """Frontend-agnostic sanity diagnostics for one resolved KernelCase."""
    failures: List[str] = []
    stmts = {s.name: s for s in case.kernel.statements}
    if len(stmts) != len(case.kernel.statements):
        failures.append(f"{name}: duplicate statement names in kernel")
    for cname in case.compute:
        if cname not in stmts:
            failures.append(f"{name}: compute process {cname!r} is not a "
                            f"statement of the kernel")
    for sname, tiling in case.tilings.items():
        if sname not in stmts:
            failures.append(f"{name}: tiling attached to unknown statement "
                            f"{sname!r}")
            continue
        d = len(stmts[sname].dims)
        for row in tiling.normals:
            if len(row) != d:
                failures.append(f"{name}: tiling normal {tuple(row)} of "
                                f"{sname!r} has {len(row)} entries for "
                                f"{d} loop dims")
    return failures


def check_registry(names: Optional[Sequence[str]] = None,
                   scale: int = 1) -> List[str]:
    """Build + validate every registered kernel; returns failure strings
    (empty = all specs valid)."""
    from ..core import registry
    # ensure the built-in suite is registered before walking the registry
    from ..core import polybench  # noqa: F401

    failures: List[str] = []
    for name in (registry.kernel_names() if names is None else names):
        try:
            case = registry.get(name, scale)
        except SpecError as e:
            failures.extend(f"{name}: {d}" for d in e.diagnostics)
            continue
        except Exception as e:                      # registry must not crash
            failures.append(f"{name}: {type(e).__name__}: {e}")
            continue
        failures.extend(check_case(name, case))
    return failures
