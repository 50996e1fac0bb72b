"""Channel sizing (paper §4, heuristic of [1] Bee+Cl@k-style).

We bound each channel by its maximal occupancy — the largest number of values
written but not yet (finally) read — under the tiled sequential execution of
the program (the global schedule the tiling induces; any self-timed execution
that respects the channel's blocking semantics needs at most this for FIFO
channels).  The paper's heuristic then rounds the capacity to a power of two;
splitting produces lower-dimensional pieces for which the bound is tighter —
occasionally *reducing* total storage (gemm in Table 1), which we reproduce.

The occupancy sweep is fully vectorized: global timestamps and their lex
ranks are computed once per process (shared across channels via
``SizingContext``), the per-value last read is a grouped argmax over ranks,
and the event sweep is a lexsort + cumulative sum.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from .deprecation import deprecated_shim
from .patterns import _lex_rank
from .ppn import PPN, Channel

_NEG = -(10 ** 9)


class SizingContext:
    """Per-process global timestamps + lex ranks, computed once and shared by
    every channel-capacity query (and across PPNs sharing Process objects).
    Timestamps/ranks come from the `Process` cache tiers, so a retiled sweep
    recomputes only the tile coordinates and the composite rank."""

    #: total constructor calls — see ChannelClassifier.construction_count.
    construction_count = 0

    def __init__(self, ppn: PPN):
        SizingContext.construction_count += 1
        self.ppn = ppn
        self._proc: Dict[str, Tuple[object, object, np.ndarray, np.ndarray]] = {}
        self._pair: Dict[Tuple[str, str], Tuple[object, object, np.ndarray,
                                                np.ndarray]] = {}

    def _proc_data(self, name: str):
        proc = self.ppn.processes[name]
        cached = self._proc.get(name)
        if cached is not None and cached[0] is proc:
            return cached
        cached = (proc, proc.domain_index(),
                  proc.global_ts(proc.pts, self.ppn.params),
                  proc.global_rank(self.ppn.params))
        self._proc[name] = cached
        return cached

    def ts_and_rank(self, proc_name: str, pts: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        _, index, gts, rank = self._proc_data(proc_name)
        rows = index.rows_of(pts)
        return gts[rows], rank[rows]

    def pair_rank(self, prod_name: str, cons_name: str
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """JOINT dense lex ranks of both full domains under the global
        schedule (shorter timestamps padded with ``_NEG``, as the occupancy
        sweep has always compared them).  One ranking per process pair serves
        every channel between the pair — including all its SPLIT parts — so
        each capacity query below is pure integer arithmetic.

        Three tiers, cheapest first:
        1. self-pair — the joint rank IS the process rank;
        2. disjoint leading constants (load → compute → store nests) — the
           joint rank is the per-process ranks with the later process offset;
        3. general — rank segment-compressed columns, reusing a sweep-cached
           joint rank of the tiling-independent tail when the endpoints share
           a tile depth, or the padded full-width matrices otherwise.
        """
        key = (prod_name, cons_name)
        prod_data = self._proc_data(prod_name)
        cons_data = self._proc_data(cons_name)
        cached = self._pair.get(key)
        if (cached is not None and cached[0] is prod_data[0]
                and cached[1] is cons_data[0]):
            return cached[2], cached[3]
        prod, cons = prod_data[0], cons_data[0]
        params = self.ppn.params
        if prod is cons:                                       # tier 1
            jp = jc = prod_data[3]
        elif prod._custom_ts("global_ts") or cons._custom_ts("global_ts"):
            # overridden timestamps: no segment structure to exploit
            jp, jc = self._joint_full(prod_data[2], cons_data[2])
        else:
            p_lo, p_hi = prod.c0_range(params)
            c_lo, c_hi = cons.c0_range(params)
            rank_p, rank_c = prod_data[3], cons_data[3]
            if p_hi < c_lo:                                    # tier 2
                jp = rank_p
                jc = rank_c + (int(rank_p.max()) + 1 if len(rank_p) else 0)
            elif c_hi < p_lo:
                jc = rank_c
                jp = rank_p + (int(rank_c.max()) + 1 if len(rank_c) else 0)
            else:                                              # tier 3
                jp, jc = self._joint_rank(prod, cons, prod_data[2],
                                          cons_data[2])
        self._pair[key] = (prod, cons, jp, jc)
        return jp, jc

    def _joint_full(self, wts: np.ndarray, rts: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        width = max(wts.shape[1], rts.shape[1])
        joint = np.concatenate([_pad(wts, width), _pad(rts, width)], axis=0)
        jrank = _lex_rank(joint)
        return jrank[:len(wts)], jrank[len(wts):]

    def _joint_rank(self, prod, cons, wts: np.ndarray, rts: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        params = self.ppn.params
        n_p, n_c = prod.tile_depth, cons.tile_depth
        if n_p != n_c:
            return self._joint_full(wts, rts)
        # aligned segments (c0 | φ… | rest): replace the tiling-independent
        # rest by its sweep-cached joint rank and rank the narrow composite
        # per configuration
        rest_p, rest_c = self._joint_rest_rank(prod, cons)
        cols_p = [prod._base_global(params)[:, :1], rest_p[:, None]]
        cols_c = [cons._base_global(params)[:, :1], rest_c[:, None]]
        if n_p:
            cols_p.insert(1, prod.domain_tile_coords(params))
            cols_c.insert(1, cons.domain_tile_coords(params))
        joint = np.concatenate([np.concatenate(cols_p, axis=1),
                                np.concatenate(cols_c, axis=1)], axis=0)
        jrank = _lex_rank(joint)
        return jrank[:len(wts)], jrank[len(wts):]

    def _joint_rest_rank(self, prod, cons) -> Tuple[np.ndarray, np.ndarray]:
        """Joint lex rank of the two processes' untiled global-timestamp
        tails — tiling-independent, cached for the lifetime of the sweep on
        the producer's base tier."""
        params = self.ppn.params
        store = prod.pair_cache(params)
        cached = store.get(cons.name)
        if cached is not None and cached[0] is cons.pts:
            return cached[1], cached[2]
        rest_p = prod._base_global(params)[:, 1:]
        rest_c = cons._base_global(params)[:, 1:]
        width = max(rest_p.shape[1], rest_c.shape[1])
        joint = np.concatenate([_pad(rest_p, width), _pad(rest_c, width)],
                               axis=0)
        jrank = _lex_rank(joint)
        out = (jrank[:len(rest_p)], jrank[len(rest_p):])
        store[cons.name] = (cons.pts, out[0], out[1])
        return out

    def rows_of(self, proc_name: str, pts: np.ndarray) -> np.ndarray:
        return self._proc_data(proc_name)[1].rows_of(pts)


def _pad(ts: np.ndarray, width: int) -> np.ndarray:
    if ts.shape[1] < width:
        ts = np.concatenate(
            [ts, np.full((len(ts), width - ts.shape[1]), _NEG,
                         dtype=np.int64)], axis=1)
    return ts


def _value_groups(c: Channel, w_rows: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-value edge grouping of a channel: ``(value write rows, edge
    permutation sorted by value, group start offsets)``.  Groups are keyed by
    producer DOMAIN ROW (a unique per-instance label), which makes them a
    property of the dataflow relation alone — cached on the tiling-shared
    Channel object, they survive every configuration of a sweep."""
    cached = c.__dict__.get("_value_groups")
    if cached is not None and cached[0] is c.src_pts:
        return cached[1]
    perm = np.argsort(w_rows, kind="stable")
    sorted_rows = w_rows[perm]
    starts = np.concatenate(
        [[0], np.flatnonzero(sorted_rows[1:] != sorted_rows[:-1]) + 1])
    groups = (sorted_rows[starts], perm, starts)
    c.__dict__["_value_groups"] = (c.src_pts, groups)
    return groups


def _channel_capacity(ppn: PPN, c: Channel,
                      context: Optional[SizingContext] = None) -> int:
    if c.num_edges == 0:
        return 0
    ctx = context if context is not None else SizingContext(ppn)
    ctx.ppn = ppn
    # Joint producer/consumer ranks replace the padded-timestamp comparisons:
    # everything below is integer arithmetic over dense ranks, with the only
    # lexicographic sort amortized per process pair in `pair_rank`.
    jp, jc = ctx.pair_rank(c.producer, c.consumer)
    w_rows = ctx.rows_of(c.producer, c.src_pts)
    r_rows = ctx.rows_of(c.consumer, c.dst_pts)
    r_rank = jc[r_rows]
    # A value occupies the channel from its write to its LAST read
    # (multiplicity keeps it live): segment-max of the read ranks over the
    # cached per-value grouping.
    value_rows, perm, starts = _value_groups(c, w_rows)
    w_ev = jp[value_rows]
    r_ev = np.maximum.reduceat(r_rank[perm], starts)
    # Sweep: +1 at write, -1 after last read, reads draining before writes at
    # the same timestamp (operand read precedes result write) — so the event
    # key is 2·rank + (1 if write).  Ranks are dense, so a counting sweep
    # (bincount + running sum) replaces the event sort outright.
    span = 2 * max(int(w_ev.max()), int(r_ev.max())) + 2
    occupancy = np.cumsum(np.bincount(2 * w_ev + 1, minlength=span)
                          - np.bincount(2 * r_ev, minlength=span))
    return int(max(0, occupancy.max()))


@deprecated_shim("analyze(...).size()")
def channel_capacity(ppn: PPN, c: Channel,
                     context: Optional[SizingContext] = None) -> int:
    """Max #values in flight under the tiled sequential schedule."""
    return _channel_capacity(ppn, c, context)


def tick_capacity(ppn: PPN, ch: Channel) -> int:
    """Forward-streaming buffer bound: stages run in lockstep ticks
    (tick = stage rank + local order); a value occupies the channel from its
    producer tick to its consumer tick (min 1 tick).  This is the
    double-buffer depth of the FIFO stream, not the paper's program-order
    liveness (pipelines are self-timed)."""
    if ch.num_edges == 0:
        return 0
    prod = ppn.processes[ch.producer]
    cons = ppn.processes[ch.consumer]
    w = prod.stmt_rank + prod.local_ts(ch.src_pts, ppn.params)[:, -1]
    r = cons.stmt_rank + cons.local_ts(ch.dst_pts, ppn.params)[:, -1]
    r = np.maximum(r, w + 1)
    t = np.concatenate([w, r])
    d = np.concatenate([np.ones(len(w), dtype=np.int64),
                        -np.ones(len(r), dtype=np.int64)])
    occupancy = np.cumsum(d[np.lexsort((d, t))])   # reads drain before writes
    return int(max(0, occupancy.max()))


def _lex_le(a: np.ndarray, b: np.ndarray) -> bool:
    """Scalar lex compare — the reference-oracle comparator used by the
    capacity cross-validation tests, not by the vectorized sweep."""
    for x, y in zip(a.tolist(), b.tolist()):
        if x < y:
            return True
        if x > y:
            return False
    return True


def pow2_size(capacity: int) -> int:
    """The paper's sizing heuristic rounds capacities to powers of two."""
    if capacity <= 0:
        return 0
    return 1 << (int(capacity - 1).bit_length())


def _size_channels(ppn: PPN, pow2: bool = False,
                   context: Optional[SizingContext] = None,
                   capture: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    ctx = context if context is not None else SizingContext(ppn)
    out: Dict[str, int] = {}
    for c in ppn.channels:
        cap = _channel_capacity(ppn, c, context=ctx)
        if capture is not None:
            # raw (pre-pow2) capacities for the parametric engine: closed
            # forms are fitted on these, rounding is re-applied at evaluate()
            capture[c.name] = cap
        out[c.name] = pow2_size(cap) if pow2 else cap
    return out


@deprecated_shim("analyze(...).size()")
def size_channels(ppn: PPN, pow2: bool = False,
                  context: Optional[SizingContext] = None) -> Dict[str, int]:
    return _size_channels(ppn, pow2, context)
