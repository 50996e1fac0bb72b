"""Warn-once deprecation shims for the pre-`Analysis` free-function API.

The staged driver (`core/analysis.py`) supersedes the standalone helpers
(`classify_channel`, `size_channels`, `fifoize`, ...) that each rebuilt the
per-process timestamp/rank caches on every call.  The helpers stay available
as thin delegating shims; each emits a single ``DeprecationWarning`` per
process (not per call site) the first time it is used, so a hot loop over a
deprecated entry point does not flood stderr.
"""
from __future__ import annotations

import functools
import warnings
from typing import Callable, Set, TypeVar

F = TypeVar("F", bound=Callable)

_WARNED: Set[str] = set()


def reset_deprecation_warnings() -> None:
    """Forget which shims already warned (test isolation)."""
    _WARNED.clear()


def warn_deprecated(key: str, message: str, stacklevel: int = 3) -> None:
    """Warn-once (per process) for a deprecated *parameter* or toggle —
    same registry as the function shims, for call sites where wrapping the
    whole function would deprecate too much (e.g. the comm planner's old
    ``fifo: bool`` switch).  ``stacklevel`` counts from here: pass enough to
    reach the USER'S frame (3 = caller of the warning function's caller)."""
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


def deprecated_shim(replacement: str,
                    message: "str | None" = None) -> Callable[[F], F]:
    """Mark a free function as superseded; the wrapped function warns once,
    then delegates untouched.  The default message points at the `Analysis`
    driver; pass ``message`` (``{name}`` = function name, ``{replacement}``
    = the replacement) for shims superseded by something else (e.g. the
    `repro_torch.lang` authoring frontend).
    """

    def decorate(fn: F) -> F:
        key = f"{fn.__module__}.{fn.__qualname__}"
        text = (message.format(name=fn.__qualname__, replacement=replacement)
                if message is not None
                else f"{fn.__qualname__}() is deprecated; use {replacement} "
                     f"(repro_torch.core.analysis) so per-process caches are "
                     f"shared across stages")

        @functools.wraps(fn)
        def shim(*args, **kwargs):
            if key not in _WARNED:
                _WARNED.add(key)
                warnings.warn(text, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        shim.__wrapped_impl__ = fn
        return shim  # type: ignore[return-value]

    return decorate
