"""Presburger-lite relations: finite unions of integer polyhedra relating an
input space to an output space, plus shared parameters.

Variables live in named spaces; building products of relations (as needed by
the in-order / unicity violation sets, which quantify over *two* dependence
edges) is done by renaming into fresh prefixes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from .affine import Constraint, LinExpr, eq
from .polyhedron import Polyhedron


@dataclass
class Relation:
    """A relation  { in → out : constraints }.

    ``in_vars``/``out_vars`` are the canonical variable names used inside each
    piece; parameters are free variables shared across renamings.
    """

    in_vars: Tuple[str, ...]
    out_vars: Tuple[str, ...]
    pieces: List[Polyhedron] = field(default_factory=list)
    params: Tuple[str, ...] = ()

    def renamed_pieces(self, in_prefix: str, out_prefix: str) -> Tuple[List[Polyhedron], Tuple[str, ...], Tuple[str, ...]]:
        """Rename in/out vars with fresh prefixes (params untouched)."""
        mapping = {v: f"{in_prefix}{v}" for v in self.in_vars}
        mapping.update({v: f"{out_prefix}{v}" for v in self.out_vars})
        new_in = tuple(mapping[v] for v in self.in_vars)
        new_out = tuple(mapping[v] for v in self.out_vars)
        return [p.rename(mapping) for p in self.pieces], new_in, new_out

    def intersected(self, cons: Iterable[Constraint]) -> "Relation":
        cons = list(cons)
        return Relation(self.in_vars, self.out_vars,
                        [p.intersect(cons) for p in self.pieces], self.params)

    def union(self, other: "Relation") -> "Relation":
        assert self.in_vars == other.in_vars and self.out_vars == other.out_vars
        return Relation(self.in_vars, self.out_vars,
                        self.pieces + other.pieces, self.params)

    def is_empty(self) -> bool:
        return all(p.is_empty() for p in self.pieces)

    @staticmethod
    def uniform(dims: Sequence[str], shift: Sequence[int],
                domain_in: Iterable[Constraint],
                domain_out: Iterable[Constraint],
                params: Sequence[str] = ()) -> "Relation":
        """Uniform dependence  i → i + shift  restricted to given domains.

        ``domain_in`` constrains the producer iteration (over ``dims``),
        ``domain_out`` the consumer iteration (over ``dims`` renamed with
        ``out_`` prefix).
        """
        in_vars = tuple(dims)
        out_vars = tuple(f"out_{d}" for d in dims)
        poly = Polyhedron()
        for d, od, s in zip(in_vars, out_vars, shift):
            poly.add(eq(LinExpr.var(od), LinExpr.var(d) + int(s)))
        for c in domain_in:
            poly.add(c)
        out_map = dict(zip(dims, out_vars))
        for c in domain_out:
            poly.add(c.rename(out_map))
        return Relation(in_vars, out_vars, [poly], tuple(params))
