"""Affine expressions and constraints over named integer variables.

This is the bottom layer of the Presburger-lite machinery used to implement
the paper's channel classification.  Expressions are exact (python ints),
variables are named strings so that relations over (producer, consumer,
params) spaces can be built by simple renaming.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Sequence, Tuple


def ceil_div(a: int, b: int) -> int:
    """Exact ``ceil(a / b)`` for integers, b > 0 (no float rounding)."""
    return -((-a) // b)


def floor_div(a: int, b: int) -> int:
    """Exact ``floor(a / b)`` for integers, b > 0 (no float rounding)."""
    return a // b


class LinExpr:
    """Integer-coefficient affine expression ``sum_i c_i * v_i + const``."""

    __slots__ = ("coeffs", "const")

    def __init__(self, coeffs: Mapping[str, int] | None = None, const: int = 0):
        self.coeffs: Dict[str, int] = {v: int(c) for v, c in (coeffs or {}).items() if c != 0}
        self.const = int(const)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def var(name: str, coeff: int = 1) -> "LinExpr":
        return LinExpr({name: coeff})

    @staticmethod
    def const_expr(c: int) -> "LinExpr":
        return LinExpr({}, c)

    @staticmethod
    def coerce(x) -> "LinExpr":
        if isinstance(x, LinExpr):
            return x
        if isinstance(x, int):
            return LinExpr.const_expr(x)
        if isinstance(x, str):
            return LinExpr.var(x)
        raise TypeError(f"cannot coerce {x!r} to LinExpr")

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other) -> "LinExpr":
        other = LinExpr.coerce(other)
        out = dict(self.coeffs)
        for v, c in other.coeffs.items():
            out[v] = out.get(v, 0) + c
        return LinExpr(out, self.const + other.const)

    __radd__ = __add__

    def __neg__(self) -> "LinExpr":
        return LinExpr({v: -c for v, c in self.coeffs.items()}, -self.const)

    def __sub__(self, other) -> "LinExpr":
        return self + (-LinExpr.coerce(other))

    def __rsub__(self, other) -> "LinExpr":
        return LinExpr.coerce(other) + (-self)

    def __mul__(self, k: int) -> "LinExpr":
        k = int(k)
        return LinExpr({v: c * k for v, c in self.coeffs.items()}, self.const * k)

    __rmul__ = __mul__

    # -- queries --------------------------------------------------------------
    def vars(self) -> Tuple[str, ...]:
        return tuple(self.coeffs)

    def eval(self, env: Mapping[str, int]) -> int:
        return self.const + sum(c * env[v] for v, c in self.coeffs.items())

    def rename(self, mapping: Mapping[str, str]) -> "LinExpr":
        return LinExpr({mapping.get(v, v): c for v, c in self.coeffs.items()}, self.const)

    def substitute(self, env: Mapping[str, "LinExpr | int"]) -> "LinExpr":
        out = LinExpr.const_expr(self.const)
        for v, c in self.coeffs.items():
            if v in env:
                out = out + LinExpr.coerce(env[v]) * c
            else:
                out = out + LinExpr.var(v, c)
        return out

    def content_normalized(self) -> "LinExpr":
        """Divide all coefficients (not the constant) by their gcd — for
        integer tightening of ``expr >= 0`` rows: g*x + c >= 0  ⇔
        x >= ceil(-c/g)  ⇔  x + floor(c/g) >= 0."""
        g = 0
        for c in self.coeffs.values():
            g = math.gcd(g, abs(c))
        if g <= 1:
            return self
        return LinExpr({v: c // g for v, c in self.coeffs.items()},
                       floor_div(self.const, g))

    def __eq__(self, other) -> bool:
        if not isinstance(other, LinExpr):
            return NotImplemented
        return self.coeffs == other.coeffs and self.const == other.const

    def __hash__(self):
        return hash((frozenset(self.coeffs.items()), self.const))

    def __repr__(self) -> str:
        parts = [f"{c:+d}·{v}" for v, c in sorted(self.coeffs.items())]
        parts.append(f"{self.const:+d}")
        return " ".join(parts) if parts else "0"


def v(name: str) -> LinExpr:
    """Shorthand variable constructor."""
    return LinExpr.var(name)


@dataclass(frozen=True)
class Constraint:
    """``expr >= 0`` (is_eq=False) or ``expr == 0`` (is_eq=True)."""

    expr: LinExpr
    is_eq: bool = False

    def rename(self, mapping: Mapping[str, str]) -> "Constraint":
        return Constraint(self.expr.rename(mapping), self.is_eq)

    def substitute(self, env) -> "Constraint":
        return Constraint(self.expr.substitute(env), self.is_eq)

    def holds(self, env: Mapping[str, int]) -> bool:
        val = self.expr.eval(env)
        return val == 0 if self.is_eq else val >= 0

    def __repr__(self) -> str:
        return f"{self.expr} {'==' if self.is_eq else '>='} 0"


# -- constraint sugar ---------------------------------------------------------

def ge(a, b) -> Constraint:       # a >= b
    return Constraint(LinExpr.coerce(a) - LinExpr.coerce(b))


def le(a, b) -> Constraint:       # a <= b
    return Constraint(LinExpr.coerce(b) - LinExpr.coerce(a))


def gt(a, b) -> Constraint:       # a > b   (integers: a >= b+1)
    return Constraint(LinExpr.coerce(a) - LinExpr.coerce(b) - 1)


def lt(a, b) -> Constraint:       # a < b
    return Constraint(LinExpr.coerce(b) - LinExpr.coerce(a) - 1)


def eq(a, b) -> Constraint:
    return Constraint(LinExpr.coerce(a) - LinExpr.coerce(b), is_eq=True)
