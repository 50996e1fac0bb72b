"""Kernel IR and exact direct-dependence (dataflow) analysis.

The paper consumes *direct dependences* — each read instance is related to the
instance that produced the value it reads (Feautrier's array dataflow
analysis).  We implement an exact enumerative engine: for fixed structure
parameters, execute the polyhedral program abstractly in schedule order and
record, for every read, the last write to the same cell.  This is the
semantics-defining oracle (the paper's tool computes the same relation
symbolically with ISL/PIP; for the uniform-dependence channels that dominate
the benchmarks we also build the symbolic `Relation` directly).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .affine import Constraint, LinExpr
from .polyhedron import Polyhedron
from .schedule import AffineSchedule

NEG_INF = -(10 ** 9)


@dataclass(frozen=True)
class Access:
    array: str
    fn: Tuple[LinExpr, ...]     # index expressions over stmt dims (+ params)


@dataclass
class Statement:
    name: str
    dims: Tuple[str, ...]
    domain: List[Constraint]          # over dims + params
    schedule: AffineSchedule          # 2d+1-style global timestamp
    writes: List[Access] = field(default_factory=list)
    reads: List[Access] = field(default_factory=list)


@dataclass
class Kernel:
    name: str
    params: Dict[str, int]            # default concrete sizes
    statements: List[Statement]
    arrays: Dict[str, Tuple[int, ...]] = field(default_factory=dict)

    def statement(self, name: str) -> Statement:
        for s in self.statements:
            if s.name == name:
                return s
        raise KeyError(name)


# ---------------------------------------------------------------- evaluation

def _expr_matrix(exprs: Sequence[LinExpr], dims: Sequence[str],
                 params: Mapping[str, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Return (M, c) with  value = pts @ M.T + c  for integer points."""
    m = np.zeros((len(exprs), len(dims)), dtype=np.int64)
    c = np.zeros(len(exprs), dtype=np.int64)
    for r, e in enumerate(exprs):
        c[r] = e.const
        for vname, coeff in e.coeffs.items():
            if vname in params:
                c[r] += coeff * params[vname]
            else:
                m[r, dims.index(vname)] = coeff
    return m, c


def enumerate_domain(stmt: Statement, params: Mapping[str, int]) -> np.ndarray:
    """Integer points of the statement domain as an (N × d) array."""
    poly = Polyhedron(c.substitute({p: LinExpr.const_expr(v)
                                    for p, v in params.items()})
                      for c in stmt.domain)
    if not stmt.dims:
        return np.zeros((1, 0), dtype=np.int64)
    box = poly.bounding_box()
    for d in stmt.dims:
        if d not in box:
            raise ValueError(f"{stmt.name}: dim {d} unbounded")
    grids = np.meshgrid(*[np.arange(box[d][0], box[d][1] + 1) for d in stmt.dims],
                        indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1).astype(np.int64)
    if pts.size == 0:
        return pts.reshape(0, len(stmt.dims))
    m, c = _expr_matrix([r for r in poly.rows], stmt.dims, {})
    vals = pts @ m.T + c
    return pts[(vals >= 0).all(axis=1)]


def eval_exprs(exprs: Sequence[LinExpr], dims: Sequence[str],
               pts: np.ndarray, params: Mapping[str, int]) -> np.ndarray:
    m, c = _expr_matrix(exprs, list(dims), params)
    return pts @ m.T + c


# ------------------------------------------------------------------ dataflow

@dataclass
class DepEdges:
    """All direct dependences for one (producer stmt, consumer stmt, read ref).

    src_pts[k] (producer iteration) produced the value read by dst_pts[k]
    (consumer iteration).  This is the paper's dataflow relation →c of the
    canonical channel partition: one channel per producer/read-reference pair.
    """

    producer: str
    consumer: str
    ref: int                     # read-reference index within the consumer
    array: str
    src_pts: np.ndarray          # (E × d_P)
    dst_pts: np.ndarray          # (E × d_C)

    @property
    def num_edges(self) -> int:
        return self.src_pts.shape[0]


def direct_dependences(kernel: Kernel, params: Optional[Mapping[str, int]] = None
                       ) -> List[DepEdges]:
    """Exact direct dependences by abstract execution in schedule order.

    Vectorized: every access instance is assigned its position in the global
    schedule order; per (array, index-arity) group the cells are interned with
    ``np.unique`` and each read is matched to the latest write of the same
    cell at a strictly earlier position via one ``searchsorted``.  A read at
    the same position as a write (the instance reading its own operand before
    writing its result) matches the *previous* writer, exactly as the
    schedule-order abstract interpretation did.
    """
    params = dict(kernel.params, **(params or {}))

    # Enumerate all instances + global timestamps (padded to equal length).
    all_pts: List[np.ndarray] = []
    all_ts: List[np.ndarray] = []
    max_len = max(len(s.schedule) for s in kernel.statements)
    for si, s in enumerate(kernel.statements):
        pts = enumerate_domain(s, params)
        ts = eval_exprs(s.schedule.exprs, s.dims, pts, params)
        if ts.shape[1] < max_len:
            pad = np.full((ts.shape[0], max_len - ts.shape[1]), NEG_INF,
                          dtype=np.int64)
            ts = np.concatenate([ts, pad], axis=1)
        all_pts.append(pts)
        all_ts.append(ts)

    ts_cat = np.concatenate(all_ts, axis=0)
    order = np.lexsort(ts_cat.T[::-1])
    pos = np.empty(len(ts_cat), dtype=np.int64)
    pos[order] = np.arange(len(ts_cat))
    base = np.cumsum([0] + [len(p) for p in all_pts])[:-1]

    # Gather write/read access instances per (array, index arity).
    groups: Dict[Tuple[str, int], Dict[str, list]] = {}
    for si, s in enumerate(kernel.statements):
        n_i = len(all_pts[si])
        gpos = pos[base[si]:base[si] + n_i]
        li = np.arange(n_i)
        for wi, acc in enumerate(s.writes):
            cells = eval_exprs(acc.fn, s.dims, all_pts[si], params)
            g = groups.setdefault((acc.array, cells.shape[1]),
                                  {"w": [], "r": []})
            g["w"].append((cells, gpos, si, li, wi))
        for ri, acc in enumerate(s.reads):
            cells = eval_exprs(acc.fn, s.dims, all_pts[si], params)
            g = groups.setdefault((acc.array, cells.shape[1]),
                                  {"w": [], "r": []})
            g["r"].append((cells, gpos, si, li, ri))

    edges: Dict[Tuple[int, int, int], Tuple[np.ndarray, np.ndarray, str]] = {}
    n_inst = len(ts_cat)
    for (arr, _arity), g in groups.items():
        if not g["w"] or not g["r"]:
            continue
        wc = np.concatenate([w[0] for w in g["w"]], axis=0)
        wpos = np.concatenate([np.asarray(w[1]) for w in g["w"]])
        wsi = np.concatenate([np.full(len(w[0]), w[2]) for w in g["w"]])
        wli = np.concatenate([w[3] for w in g["w"]])
        wwi = np.concatenate([np.full(len(w[0]), w[4]) for w in g["w"]])
        rc = np.concatenate([r[0] for r in g["r"]], axis=0)
        rpos = np.concatenate([np.asarray(r[1]) for r in g["r"]])
        rsi = np.concatenate([np.full(len(r[0]), r[2]) for r in g["r"]])
        rli = np.concatenate([r[3] for r in g["r"]])
        rri = np.concatenate([np.full(len(r[0]), r[4]) for r in g["r"]])

        _, cid = np.unique(np.concatenate([wc, rc], axis=0), axis=0,
                           return_inverse=True)
        wcid, rcid = cid[:len(wc)], cid[len(wc):]
        # composite (cell, position) key; positions are < n_inst
        wkey = wcid.astype(np.int64) * n_inst + wpos
        rkey = rcid.astype(np.int64) * n_inst + rpos
        worder = np.lexsort((wwi, wkey))
        wkey_sorted = wkey[worder]
        # rightmost write with key < read key == the read's last-writer;
        # ties on (cell, pos) resolve to the instance's last write (max wi).
        match = np.searchsorted(wkey_sorted, rkey, side="left") - 1
        valid = match >= 0
        midx = worder[np.clip(match, 0, None)]
        valid &= wcid[midx] == rcid
        if not bool(valid.any()):
            continue
        midx, p_si = midx[valid], wsi[midx[valid]]
        c_si, c_ri = rsi[valid], rri[valid]
        p_li, c_li, r_at = wli[midx], rli[valid], rpos[valid]
        bucket_keys = np.stack([p_si, c_si, c_ri], axis=1)
        uniq, inv = np.unique(bucket_keys, axis=0, return_inverse=True)
        for b, (pi, ci, ri) in enumerate(uniq):
            sel = inv == b
            # edges ordered by consumer schedule position, as the abstract
            # execution appended them
            by_pos = np.argsort(r_at[sel], kind="stable")
            edges[(int(pi), int(ci), int(ri))] = (
                p_li[sel][by_pos], c_li[sel][by_pos], arr)

    out: List[DepEdges] = []
    for (pi, ci, ri) in sorted(edges):
        srcs, dsts, arr = edges[(pi, ci, ri)]
        out.append(DepEdges(
            producer=kernel.statements[pi].name,
            consumer=kernel.statements[ci].name,
            ref=ri, array=arr,
            src_pts=all_pts[pi][srcs],
            dst_pts=all_pts[ci][dsts],
        ))
    return out
