"""Affine schedules and lexicographic-order constraint builders.

A schedule maps an iteration vector to a multidimensional timestamp ordered by
``≪`` (lexicographic).  The paper partitions ``≪`` by *depth*:
``≪ = ≪¹ ⊎ … ⊎ ≪ᵈ`` with ``u ≪ᵏ v  iff  u[:k-1] == v[:k-1] ∧ u[k-1] < v[k-1]``.

The builders below return constraint lists (conjunctions) or lists of
constraint lists (disjunctions over depth) over whatever variable space the
caller has renamed the timestamp expressions into.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Mapping, Sequence

from .affine import Constraint, LinExpr, eq, lt

# -- program phases ----------------------------------------------------------
#
# The leading constant (c0) of a 2d+1 global schedule orders whole statement
# nests.  Boundary processes live in dedicated phases around the computation:
#
#     prologue (loads)  ≪  body (compute, c0 = 0 .. n-1)  ≪  epilogue (stores)
#
# The prologue sits at a fixed c0 = -1 (every body phase is non-negative);
# the epilogue's c0 is the first constant after the body phases — computed
# from the program, not a magic sentinel (this replaces the old
# ``BIG = 10**6`` hack that polybench.py hand-rolled).  Within a phase,
# boundary processes are ordered by their registration rank, which
# `boundary_schedule` makes the second schedule component — so the ordering
# holds under ANY tiling: tile coordinates are spliced *after* c0
# (`Process.global_ts`), and the phase constants never tie.

#: leading schedule constant of every prologue (load) process
PROLOGUE_C0 = -1

#: conservative epilogue c0 for legacy callers that cannot know the body
#: span (the deprecated ``polybench.store`` shim predates phase derivation);
#: programs compiled by `repro_torch.lang` use the exact `epilogue_c0` of their
#: own body instead — only the ORDER of the leading constants is meaningful
LEGACY_EPILOGUE_C0 = 10 ** 6


def epilogue_c0(body_c0s: Iterable[int]) -> int:
    """First c0 strictly after every body phase: epilogue (store) processes
    scheduled here sort after the whole computation, under any tiling."""
    return max(body_c0s, default=-1) + 1


def boundary_schedule(dims: Sequence[str], c0: int, rank: int) -> "AffineSchedule":
    """``(c0, rank, *dims)`` — the global timestamp of a boundary process:
    phase constant first, registration rank second, then its own counters."""
    return AffineSchedule(
        tuple(dims),
        [LinExpr.const_expr(c0), LinExpr.const_expr(rank)]
        + [LinExpr.var(d) for d in dims])


@dataclass
class AffineSchedule:
    """Timestamp expressions over named dims (+ parameters)."""

    dims: tuple
    exprs: List[LinExpr]

    def rename(self, mapping: Mapping[str, str]) -> List[LinExpr]:
        return [e.rename(mapping) for e in self.exprs]

    def eval(self, env: Mapping[str, int]) -> tuple:
        return tuple(e.eval(env) for e in self.exprs)

    def __len__(self) -> int:
        return len(self.exprs)

    @staticmethod
    def identity(dims: Sequence[str]) -> "AffineSchedule":
        return AffineSchedule(tuple(dims), [LinExpr.var(d) for d in dims])


# -- lexicographic constraint builders ---------------------------------------

def lex_lt_at_depth(ts_a: Sequence[LinExpr], ts_b: Sequence[LinExpr],
                    k: int) -> List[Constraint]:
    """Conjunction for ``ts_a ≪ᵏ ts_b`` (k is 1-based)."""
    cons = [eq(ts_a[i], ts_b[i]) for i in range(k - 1)]
    cons.append(lt(ts_a[k - 1], ts_b[k - 1]))
    return cons


def lex_lt_pieces(ts_a: Sequence[LinExpr], ts_b: Sequence[LinExpr]) -> List[List[Constraint]]:
    """Disjunction (list of conjunctions) for strict ``ts_a ≪ ts_b``."""
    depth = min(len(ts_a), len(ts_b))
    return [lex_lt_at_depth(ts_a, ts_b, k) for k in range(1, depth + 1)]


def prefix_eq(ts_a: Sequence[LinExpr], ts_b: Sequence[LinExpr],
              n: int) -> List[Constraint]:
    """Conjunction for ``ts_a ≈ⁿ ts_b`` (first n coordinates equal)."""
    return [eq(ts_a[i], ts_b[i]) for i in range(n)]
