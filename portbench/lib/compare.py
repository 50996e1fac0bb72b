"""The comparison that decides `correct`, and the lower precisions of its
control.

A job's output is held to the program's plain reference computed in
float64 from the same input: the number compared is the widest gap, as a
share of the reference's largest magnitude,
``max |y - ref| / max |ref|``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class Check:
    """One number compared beside its limit: ``rule`` is ``"<="`` (the
    value may not pass the limit) or ``"=="`` (exact)."""

    name: str
    value: float
    limit: float
    rule: str = "<="

    @property
    def ok(self) -> bool:
        if self.rule == "==":
            return self.value == self.limit
        return self.value <= self.limit      # NaN fails

    def as_dict(self) -> dict:
        return {"value": self.value, "limit": self.limit, "rule": self.rule,
                "ok": self.ok}

    def line(self) -> str:
        return (f"check {self.name} = {self.value!r} (limit {self.rule} "
                f"{self.limit!r}): {'ok' if self.ok else 'FAILED'}")


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / max |want|`` in float64; NaN or inf where
    ``got`` is not finite, so it fails any limit."""
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    want = want.to(torch.float64)
    gap = (got.to(torch.float64) - want).abs().max()
    return float(gap / want.abs().max())


def sweeps(sweep: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
           n: int, level: Optional[Callable] = None) -> torch.Tensor:
    """``n`` sweeps of ``sweep`` from ``x`` in ``x``'s dtype; with
    ``level``, each sweep's input is rounded by it first (the control's
    lower precision, the products accumulated in ``x``'s dtype)."""
    a = x
    for _ in range(n):
        a = sweep(a if level is None else level(a))
    return a


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32 (10 mantissa bits, to nearest, ties to
    even), kept in float32: what the tensor cores read of a float32
    operand with TF32 on.  For finite values below float32's largest."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def bf16(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to bfloat16, kept in float32."""
    return a.to(torch.bfloat16).to(torch.float32)


#: the control's lower precisions, by name: float32 levels read as TF32
#: (the nearest below float32 with TF32 off) and as bfloat16
CONTROLS = {"tf32": tf32, "bf16": bf16}
