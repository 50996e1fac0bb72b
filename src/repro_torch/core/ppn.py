"""Polyhedral Process Networks (paper §2.3).

A PPN is (P, C): processes = iteration domain + sequential *local* schedule
(the leading 2d+1 constants of the program schedule are dropped — order is
local to the process, the global order is driven by dataflow); channels =
partition of the direct dependences, canonically one channel per
(producer process, consumer read reference).
"""
from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .dataflow import DepEdges, Kernel, direct_dependences, enumerate_domain, eval_exprs
from .schedule import AffineSchedule
from .tiling import Tiling


class DomainIndex:
    """Vectorized lookup from integer points to their row in a domain array.

    Points are encoded to a single scalar by mixed-radix packing over the
    domain's bounding box (falls back to a bytes-keyed dict when the box is
    too large to pack into int64).  Channels built from a process domain can
    then map their edge endpoints to domain rows in O(E log N) numpy ops
    instead of per-edge Python hashing.
    """

    #: bound on pinned (pts-id → rows) entries; oldest half drops on overflow
    _ROWS_MEMO_LIMIT = 1024

    def __init__(self, pts: np.ndarray):
        self.pts = pts
        self._rows_memo: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        n, d = pts.shape
        self._packed = False
        if n and d:
            lo = pts.min(axis=0).astype(np.int64)
            extents = pts.max(axis=0).astype(np.int64) - lo + 1
            total = 1
            for e in extents.tolist():
                total *= int(e)
            if total < (1 << 62):
                strides = np.ones(d, dtype=np.int64)
                for j in range(d - 2, -1, -1):
                    strides[j] = strides[j + 1] * extents[j + 1]
                self._lo, self._strides, self._extents = lo, strides, extents
                codes = (pts - lo) @ strides
                self._order = np.argsort(codes, kind="stable")
                self._codes = codes[self._order]
                self._packed = True
        if not self._packed:
            self._map = {row.tobytes(): i
                         for i, row in enumerate(np.ascontiguousarray(pts))}

    def rows_of(self, pts: np.ndarray) -> np.ndarray:
        """Domain row index of each point; raises if a point is absent.

        Lookups are memoized per query-array identity (the array is pinned in
        the memo, so a recycled ``id`` cannot alias): channel endpoint arrays
        are shared across analysis stages — and, in a tile sweep, across every
        retiled configuration — so each is resolved once per index lifetime.
        Callers treat the returned rows as read-only.
        """
        hit = self._rows_memo.get(id(pts))
        if hit is not None and hit[0] is pts:
            return hit[1]
        rows = self._rows_of_uncached(pts)
        self.prime(pts, rows)
        return rows

    def prime(self, pts: np.ndarray, rows: np.ndarray) -> None:
        """Pre-seed the lookup memo (e.g. SPLIT parts slice their parent's
        already-resolved rows instead of re-searching the domain)."""
        memo = self._rows_memo
        if len(memo) >= self._ROWS_MEMO_LIMIT:
            # drop the oldest half: long sweeps retire old configurations'
            # part arrays while the shared channel arrays stay resident
            for k in list(itertools.islice(iter(memo), len(memo) // 2)):
                del memo[k]
        memo[id(pts)] = (pts, rows)

    def _rows_of_uncached(self, pts: np.ndarray) -> np.ndarray:
        if pts.shape[0] == 0:
            return np.zeros(0, dtype=np.intp)
        if not self._packed:
            contig = np.ascontiguousarray(pts)
            return np.array([self._map[row.tobytes()] for row in contig],
                            dtype=np.intp)
        # out-of-box points can alias in-box codes — reject them first
        shifted = pts - self._lo
        if not bool(np.all((shifted >= 0) & (shifted < self._extents))):
            raise KeyError("point not in domain")
        codes = shifted @ self._strides
        slot = np.searchsorted(self._codes, codes)
        slot = np.clip(slot, 0, len(self._codes) - 1)
        if not bool(np.all(self._codes[slot] == codes)):
            raise KeyError("point not in domain")
        return self._order[slot]


@dataclass
class Process:
    name: str
    dims: Tuple[str, ...]
    schedule: AffineSchedule                 # local order over dims
    pts: np.ndarray                          # enumerated domain (N × d)
    tiling: Optional[Tiling] = None
    stmt_rank: int = 0                       # position in original program text
    global_sched: Optional[AffineSchedule] = None   # original 2d+1 timestamp

    def domain_index(self) -> DomainIndex:
        idx = self.__dict__.get("_domain_index")
        if idx is None or idx.pts is not self.pts:
            idx = DomainIndex(self.pts)
            self.__dict__["_domain_index"] = idx
        return idx

    # ------------------------------------------------------------- caches --
    # Two cache tiers, both lazy and keyed on (pts identity, params):
    #   * `_base_cache` holds everything TILING-INDEPENDENT (untiled local /
    #     global timestamps over the full domain and their lex ranks).  It is
    #     carried over by `retiled()`, so a tile sweep evaluates the schedule
    #     polynomials and ranks the untiled columns exactly once per kernel.
    #   * `_tile_cache` holds the per-tiling derivatives (φ over the domain,
    #     full timestamps, compressed lex ranks) — never copied across
    #     retilings.
    # Lex ranks of composite timestamps are computed on SEGMENT-COMPRESSED
    # columns: each tiling-independent segment is replaced by its own lex
    # rank (one column), which preserves lexicographic order segment-wise and
    # therefore yields bit-identical dense ranks at a fraction of the width.

    def _cache(self, slot: str, params: Mapping[str, int]) -> Dict:
        pk = tuple(sorted(params.items()))
        c = self.__dict__.get(slot)
        if c is None or c["pts"] is not self.pts or c["params"] != pk:
            c = {"pts": self.pts, "params": pk}
            self.__dict__[slot] = c
        return c

    def _base_local(self, params: Mapping[str, int]) -> np.ndarray:
        c = self._cache("_base_cache", params)
        if "local" not in c:
            c["local"] = eval_exprs(self.schedule.exprs, self.dims, self.pts,
                                    params)
        return c["local"]

    def _base_local_rank(self, params: Mapping[str, int]) -> np.ndarray:
        c = self._cache("_base_cache", params)
        if "local_rank" not in c:
            from .patterns import _lex_rank
            c["local_rank"] = _lex_rank(self._base_local(params))
        return c["local_rank"]

    def _base_global(self, params: Mapping[str, int]) -> np.ndarray:
        c = self._cache("_base_cache", params)
        if "global" not in c:
            if self.global_sched is not None:
                base = eval_exprs(self.global_sched.exprs, self.dims,
                                  self.pts, params)
            else:
                rank = np.full((len(self.pts), 1), self.stmt_rank,
                               dtype=np.int64)
                base = np.concatenate(
                    [rank, eval_exprs(self.schedule.exprs, self.dims,
                                      self.pts, params)], axis=1)
            c["global"] = base
        return c["global"]

    def _base_global_seg_ranks(self, params: Mapping[str, int]
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """Lex ranks of the (c0) and (rest) segments of the untiled global
        timestamp — φ is spliced between them by the tiled schedule."""
        c = self._cache("_base_cache", params)
        if "global_seg" not in c:
            from .patterns import _lex_rank
            base = self._base_global(params)
            c["global_seg"] = (_lex_rank(base[:, :1]), _lex_rank(base[:, 1:]))
        return c["global_seg"]

    def domain_tile_coords(self, params: Mapping[str, int]
                           ) -> Optional[np.ndarray]:
        """φ of every domain point under this process's tiling (cached)."""
        if self.tiling is None:
            return None
        c = self._cache("_tile_cache", params)
        if "phi" not in c:
            c["phi"] = self.tiling.tile_coords_of(self.pts)
        return c["phi"]

    def _custom_ts(self, attr: str) -> bool:
        """Subclasses may override the timestamp functions (the comm
        planner's pipeline processes do) — every segment-compressed fast
        path must then defer to the override."""
        return getattr(type(self), attr) is not getattr(Process, attr)

    def local_rank(self, params: Mapping[str, int]) -> np.ndarray:
        """Dense lex rank of every domain point under the (possibly tiled)
        local schedule — identical to ``_lex_rank(local_ts(pts))``."""
        from .patterns import _lex_rank
        if self._custom_ts("local_ts"):
            c = self._cache("_tile_cache", params)
            if "local_rank" not in c:
                c["local_rank"] = _lex_rank(self.local_ts(self.pts, params))
            return c["local_rank"]
        if self.tiling is None:
            return self._base_local_rank(params)
        c = self._cache("_tile_cache", params)
        if "local_rank" not in c:
            phi = self.domain_tile_coords(params)
            base_rank = self._base_local_rank(params)
            c["local_rank"] = _lex_rank(
                np.concatenate([phi, base_rank[:, None]], axis=1))
        return c["local_rank"]

    def global_rank(self, params: Mapping[str, int]) -> np.ndarray:
        """Dense lex rank of every domain point under the (possibly tiled)
        global schedule — identical to ``_lex_rank(global_ts(pts))``."""
        from .patterns import _lex_rank
        if self._custom_ts("global_ts"):
            c = self._cache("_tile_cache", params)
            if "global_rank" not in c:
                c["global_rank"] = _lex_rank(self.global_ts(self.pts, params))
            return c["global_rank"]
        if self.tiling is None:        # tiling-independent: base tier
            c = self._cache("_base_cache", params)
            if "global_rank" not in c:
                c["global_rank"] = _lex_rank(self._base_global(params))
            return c["global_rank"]
        c = self._cache("_tile_cache", params)
        if "global_rank" not in c:
            c0_rank, rest_rank = self._base_global_seg_ranks(params)
            phi = self.domain_tile_coords(params)
            c["global_rank"] = _lex_rank(np.concatenate(
                [c0_rank[:, None], phi, rest_rank[:, None]], axis=1))
        return c["global_rank"]

    def c0_range(self, params: Mapping[str, int]) -> Tuple[int, int]:
        """(min, max) of the leading global-schedule constant — disjoint
        ranges let two processes' joint lex rank decompose into per-process
        ranks plus an offset (no cross-process ranking at all)."""
        c = self._cache("_base_cache", params)
        if "c0_range" not in c:
            col = self._base_global(params)[:, 0]
            c["c0_range"] = ((int(col.min()), int(col.max())) if len(col)
                             else (0, 0))
        return c["c0_range"]

    def pair_cache(self, params: Mapping[str, int]) -> Dict:
        """Sweep-lifetime store for joint-rank segments shared with OTHER
        processes (lives in the base tier, keyed by consumer name there)."""
        return self._cache("_base_cache", params).setdefault("pair", {})

    def local_ts(self, pts: np.ndarray, params: Mapping[str, int]) -> np.ndarray:
        """Timestamps under the (possibly tiled) local schedule: (φ…, base…)."""
        full_domain = pts is self.pts
        base = (self._base_local(params) if full_domain
                else eval_exprs(self.schedule.exprs, self.dims, pts, params))
        if self.tiling is None:
            return base
        phi = (self.domain_tile_coords(params) if full_domain
               else self.tiling.tile_coords_of(pts))
        return np.concatenate([phi, base], axis=1)

    def global_ts(self, pts: np.ndarray, params: Mapping[str, int]) -> np.ndarray:
        """Program-wide timestamp for sizing: (c0, φ…, rest of the 2d+1
        schedule) — the leading 2d+1 constant still orders whole statement
        nests (load → compute → store), the tile coordinates order tiles
        within the tiled nest, and statements interleave inside a tile as in
        the original program.  Keeping c0 first makes timestamps comparable
        across tiled and untiled processes."""
        full_domain = pts is self.pts
        if full_domain:
            base = self._base_global(params)
        elif self.global_sched is not None:
            base = eval_exprs(self.global_sched.exprs, self.dims, pts, params)
        else:
            rank = np.full((len(pts), 1), self.stmt_rank, dtype=np.int64)
            base = np.concatenate(
                [rank, eval_exprs(self.schedule.exprs, self.dims, pts, params)],
                axis=1)
        if self.tiling is None:
            return base
        phi = (self.domain_tile_coords(params) if full_domain
               else self.tiling.tile_coords_of(pts))
        return np.concatenate([base[:, :1], phi, base[:, 1:]], axis=1)

    def retiled(self, tiling: Optional[Tiling],
                params: Mapping[str, int]) -> "Process":
        """A copy of this process under another tiling, sharing the domain,
        the `DomainIndex`, and the tiling-independent cache tier — the
        foundation of `Analysis.retile`.

        The shared containers are materialized HERE (empty if need be, lazy
        fields fill later): they are shared by reference, so whatever any
        retiled copy computes into them becomes visible to the source and to
        every later copy.  Without this, work done under one configuration
        would die with it."""
        self.domain_index()                     # materialize shared slots on
        self._cache("_base_cache", params)      # the SOURCE before copying
        p = copy.copy(self)   # not dataclasses.replace: subclasses may take
        p.tiling = tiling     # extra ctor args (the planner's _PipeProcess)
        # the per-tiling tier belongs to the OLD tiling — must not carry over
        p.__dict__.pop("_tile_cache", None)
        return p

    @property
    def tile_depth(self) -> int:
        return self.tiling.n if self.tiling is not None else 0


@dataclass
class Channel:
    """A channel with its dataflow relation (edge list form).

    ``depth`` tags channels produced by SPLIT: 1..n = crossing hyperplane k,
    n+1 = intra-tile, None = original (unsplit) channel.
    """

    producer: str
    consumer: str
    ref: int
    array: str
    src_pts: np.ndarray
    dst_pts: np.ndarray
    depth: Optional[int] = None

    @property
    def name(self) -> str:
        got = self.__dict__.get("_name")
        if got is None:
            d = f"@{self.depth}" if self.depth is not None else ""
            got = (f"{self.producer}->{self.consumer}"
                   f".{self.array}[{self.ref}]{d}")
            self.__dict__["_name"] = got
        return got

    @property
    def num_edges(self) -> int:
        return int(self.src_pts.shape[0])


@dataclass
class PPN:
    kernel_name: str
    params: Dict[str, int]
    processes: Dict[str, Process]
    channels: List[Channel]

    @staticmethod
    def from_kernel(kernel: Kernel, params: Optional[Mapping[str, int]] = None,
                    tilings: Optional[Mapping[str, Tiling]] = None) -> "PPN":
        """Canonical PPN: one process per statement, one channel per
        (producer, consumer read reference); local schedules are the identity
        over the loop counters (same order as the original program)."""
        params = dict(kernel.params, **(params or {}))
        tilings = dict(tilings or {})
        procs: Dict[str, Process] = {}
        for rank, s in enumerate(kernel.statements):
            procs[s.name] = Process(
                name=s.name, dims=s.dims,
                schedule=AffineSchedule.identity(s.dims),
                pts=enumerate_domain(s, params),
                tiling=tilings.get(s.name),
                stmt_rank=rank,
                global_sched=s.schedule,
            )
        chans = [Channel(e.producer, e.consumer, e.ref, e.array,
                         e.src_pts, e.dst_pts)
                 for e in direct_dependences(kernel, params)]
        return PPN(kernel.name, params, procs, chans)

    def channels_between(self, producer: str, consumer: str) -> List[Channel]:
        return [c for c in self.channels
                if c.producer == producer and c.consumer == consumer]

    def retiled(self, tilings: Optional[Mapping[str, Tiling]] = None) -> "PPN":
        """This network under another tiling assignment, reusing everything
        tiling-independent: the `Channel` objects (the dataflow relation is a
        property of the program, not of the tiling), the domain arrays, their
        `DomainIndex`, and the per-process base-timestamp/rank caches.  Only
        tile coordinates and composite ranks are recomputed downstream."""
        tilings = dict(tilings or {})
        procs = {name: p.retiled(tilings.get(name), self.params)
                 for name, p in self.processes.items()}
        return PPN(self.kernel_name, dict(self.params), procs,
                   list(self.channels))
