"""Loop tiling as affine constraints.

A tiling is given by hyperplane normals ``τ₁..τₙ`` (linearly independent) and
sizes ``b₁..bₙ``.  Tile coordinates are ``φₖ = ⌊τₖ·i / bₖ⌋`` which is affine
once ``φₖ`` is introduced with the definitional constraints

    bₖ·φₖ  ≤  τₖ·i  ≤  bₖ·φₖ + bₖ - 1 .

The polyhedral model is closed under tiling: the tiled schedule is
``θ(i) = (φ₁..φₙ, i)`` (paper §2.2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from .affine import Constraint, LinExpr, ge, le
from .schedule import AffineSchedule


@dataclass(frozen=True)
class Tiling:
    """Per-statement tile-coordinate map.

    The *global* tiling of a loop nest has linearly independent normals; a
    statement living in a sub-band of the nest embeds into the common tile
    space with degenerate rows (zero normals ⇒ constant tile coordinate), so
    producers/consumers of different dimensionality still share the tile-depth
    space FIFOIZE compares (e.g. gemm's `C *= beta` statement sits at tile
    coordinate 0 along k).  Hence no per-statement independence requirement.
    """

    normals: Tuple[Tuple[int, ...], ...]   # n × d  (rows may be zero)
    sizes: Tuple[int, ...]                 # n
    offsets: Tuple[int, ...] = ()          # per-hyperplane constant shift
                                           # (per-statement schedule offset à
                                           # la Pluto's 2t / 2t+1 interleave)

    def __post_init__(self):
        assert len(self.normals) == len(self.sizes)
        if not self.offsets:
            object.__setattr__(self, "offsets", tuple(0 for _ in self.sizes))
        assert len(self.offsets) == len(self.sizes)

    @property
    def n(self) -> int:
        return len(self.normals)

    def tile_coord_exprs(self, dim_vars: Sequence[str], phi_prefix: str
                         ) -> Tuple[List[LinExpr], List[Constraint]]:
        """Return (φ expressions as fresh vars, definitional constraints)."""
        phis: List[LinExpr] = []
        cons: List[Constraint] = []
        for k, (tau, b, off) in enumerate(zip(self.normals, self.sizes,
                                              self.offsets)):
            phi = LinExpr.var(f"{phi_prefix}phi{k}")
            dot = LinExpr.const_expr(off)
            for coeff, dv in zip(tau, dim_vars):
                if coeff:
                    dot = dot + LinExpr.var(dv, coeff)
            cons.append(ge(dot, phi * b))               # b·φ ≤ τ·i + o
            cons.append(le(dot, phi * b + (b - 1)))     # τ·i + o ≤ b·φ + b-1
            phis.append(phi)
        return phis, cons

    def tile_coords_of(self, points: np.ndarray) -> np.ndarray:
        """Vectorized φ for integer points (N × d) → (N × n)."""
        taus = np.array(self.normals)                    # n × d
        dots = points @ taus.T + np.array(self.offsets)  # N × n
        return np.floor_divide(dots, np.array(self.sizes))

    def tiled_schedule(self, base: AffineSchedule, phi_prefix: str
                       ) -> Tuple[List[LinExpr], List[Constraint]]:
        """θ(i) = (φ₁..φₙ, base(i)) with φ definitional constraints."""
        phis, cons = self.tile_coord_exprs(base.dims, phi_prefix)
        return phis + list(base.exprs), cons

    def with_sizes(self, sizes: Sequence[int]) -> "Tiling":
        """Same hyperplanes (normals + offsets), different tile sizes — the
        unit of variation a tile-size sweep explores."""
        return Tiling(self.normals, tuple(int(b) for b in sizes),
                      self.offsets)


def rectangular(dim_count: int, sizes: Sequence[int]) -> Tiling:
    normals = tuple(tuple(1 if j == k else 0 for j in range(dim_count))
                    for k in range(len(sizes)))
    return Tiling(normals, tuple(sizes))


def rescale_tilings(tilings: Mapping[str, Tiling], b: int, base: int = 4
                    ) -> Dict[str, Tiling]:
    """A tiling assignment with every size rescaled by ``b / base`` (floored,
    min 1): size ``base`` becomes ``b``, ``2·base`` becomes ``2·b``, … — so a
    kernel's reference tiling (the polybench cases use ``base=4``) generates
    a whole tile-size sweep while keeping relative shapes (e.g. heat-3d's
    2×-time hyperplanes) and per-statement offsets intact."""
    return {name: t.with_sizes(max(1, s * b // base) for s in t.sizes)
            for name, t in tilings.items()}


def unit_tilings(tilings: Mapping[str, Tiling]) -> Dict[str, Tiling]:
    """The degenerate 1×…×1 assignment of the same hyperplanes (every point
    its own tile) — the sweep's boundary configuration."""
    return {name: t.with_sizes(1 for _ in t.sizes)
            for name, t in tilings.items()}
