"""Communication-pattern classification (paper §2.3).

    in-order(→c, ≺P, ≺C) := ∀ x→c x', ∀ y→c y' : x' ≺C y' ⇒ x ⪯P y
    unicity(→c)          := ∀ x→c x', ∀ y→c y' : x' ≠ y' ⇒ x ≠ y
    fifo                 := in-order ∧ unicity

Two backends:

* **enumeration** (exact for fixed structure parameters): sort the edge list
  by the consumer's local order and check the producer sequence — O(E log E);
* **symbolic** (compile-time): build the violation sets as unions of integer
  polyhedra and check emptiness (Fourier–Motzkin + integer point search), as
  the paper does with an LP/ILP solver.

Both are cross-validated against each other in the test-suite.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .affine import Constraint, LinExpr, eq
from .deprecation import deprecated_shim
from .polyhedron import Polyhedron
from .relation import Relation
from .schedule import AffineSchedule, lex_lt_at_depth
from .tiling import Tiling
from .ppn import Channel, PPN, Process


class Pattern(Enum):
    FIFO = "fifo"                               # in-order ∧ unicity
    IN_ORDER_MULT = "in-order+mult"             # in-order ∧ ¬unicity
    OOO_UNICITY = "out-of-order+unicity"        # ¬in-order ∧ unicity
    OOO = "out-of-order"                        # ¬in-order ∧ ¬unicity

    @staticmethod
    def of(in_order: bool, unicity: bool) -> "Pattern":
        if in_order:
            return Pattern.FIFO if unicity else Pattern.IN_ORDER_MULT
        return Pattern.OOO_UNICITY if unicity else Pattern.OOO


# ===================================================================== ranks

def _lex_rank(ts: np.ndarray) -> np.ndarray:
    """Rank of each row in lexicographic order — equal rows get EQUAL rank
    (x ⪯ y must treat identical timestamps as equal, and unicity compares
    source *values*).

    Computed as one `np.lexsort` + adjacent-difference cumsum: identical
    dense ranks to ``np.unique(axis=0).return_inverse`` (both orders rows by
    numeric column-lexicographic comparison) without materializing the
    structured-dtype view `np.unique` sorts through.
    """
    n = ts.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if ts.ndim != 2 or ts.shape[1] == 0:
        return np.zeros(n, dtype=np.int64)
    order = np.lexsort(ts.T[::-1])
    sorted_ts = ts[order]
    distinct = np.any(sorted_ts[1:] != sorted_ts[:-1], axis=1)
    ranks = np.empty(n, dtype=np.int64)
    ranks[order] = np.concatenate([[0], np.cumsum(distinct)])
    return ranks


# ========================================================== enumeration side

def classify_edges(src_ts: np.ndarray, dst_ts: np.ndarray) -> Tuple[bool, bool]:
    """(in_order, unicity) for an edge list with *local* timestamps."""
    n = src_ts.shape[0]
    if n == 0:
        return True, True
    src_rank = _lex_rank(src_ts)
    dst_rank = _lex_rank(dst_ts)
    order = np.argsort(dst_rank, kind="stable")
    prod_seq = src_rank[order]
    in_order = bool(np.all(np.diff(prod_seq) >= 0))
    # unicity: each produced value read exactly once ⇔ no duplicated source
    unicity = len(np.unique(src_ts, axis=0)) == n
    return in_order, unicity


def _classify_channel(ppn: PPN, c: Channel) -> Pattern:
    prod = ppn.processes[c.producer]
    cons = ppn.processes[c.consumer]
    src_ts = prod.local_ts(c.src_pts, ppn.params)
    dst_ts = cons.local_ts(c.dst_pts, ppn.params)
    in_order, unicity = classify_edges(src_ts, dst_ts)
    return Pattern.of(in_order, unicity)


@deprecated_shim("analyze(...).classify()")
def classify_channel(ppn: PPN, c: Channel) -> Pattern:
    """Per-channel slow path: recomputes both endpoint timestamp arrays on
    every call.  Kept as the reference oracle for cross-validation tests."""
    return _classify_channel(ppn, c)


# ====================================================== batched enumeration

class ChannelClassifier:
    """Batched classifier: local timestamps and lexicographic ranks are
    computed ONCE per process (over its full domain) instead of once per
    channel; each channel then maps its edge endpoints to domain rows with a
    vectorized index lookup and classifies on precomputed integer ranks.

    Ranks are order-isomorphic to the per-channel timestamps used by
    :func:`classify_edges` (equal timestamps ⇔ equal ranks), so verdicts are
    identical — cross-validated in ``tests/test_matrix_backend.py``.

    A classifier may be reused across PPNs that share ``Process`` objects
    (``fifoize`` output does), amortizing the per-process work further; it
    also memoizes per-channel verdicts keyed on the edge arrays themselves,
    so re-classifying the same Channel (before/after reports, part checks) is
    free.
    """

    #: total constructor calls (process-wide) — the Analysis driver's tests
    #: assert the staged pipeline builds exactly one classifier per analysis.
    construction_count = 0

    def __init__(self, ppn: PPN):
        ChannelClassifier.construction_count += 1
        self.ppn = ppn
        self._proc: Dict[str, Tuple[object, object, np.ndarray]] = {}
        self._verdicts: Dict[Tuple, Tuple[Tuple[bool, bool], Channel]] = {}

    def _proc_data(self, name: str):
        proc = self.ppn.processes[name]
        cached = self._proc.get(name)
        if cached is not None and cached[0] is proc:
            return cached
        # ranks come from the Process cache tiers: the untiled segment is
        # ranked once per kernel (shared across retilings), only the
        # (φ, base-rank) composite is ranked per tiling.
        rank = proc.local_rank(self.ppn.params)
        # rank injective on the domain ⟺ the local schedule is (every point
        # a distinct timestamp) — then distinct ranks ≡ distinct domain rows
        injective = rank.size == 0 or int(rank.max()) == rank.size - 1
        cached = (proc, proc.domain_index(), rank, injective)
        self._proc[name] = cached
        return cached

    def ranks_of(self, proc_name: str, pts: np.ndarray) -> np.ndarray:
        """Local-schedule lex ranks of ``pts`` (rows of the process domain)."""
        _, index, rank, _ = self._proc_data(proc_name)
        return rank[index.rows_of(pts)]

    @staticmethod
    def _distinct_sources(c: Channel, src_rows: np.ndarray) -> int:
        """Number of distinct producer instances feeding ``c`` — a property
        of the dataflow relation, so it is cached on the (tiling-shared)
        Channel object and survives every retiling of a sweep."""
        cached = c.__dict__.get("_src_distinct")
        if cached is not None and cached[0] is c.src_pts:
            return cached[1]
        distinct = len(np.unique(src_rows))
        c.__dict__["_src_distinct"] = (c.src_pts, distinct)
        return distinct

    def edge_flags(self, c: Channel) -> Tuple[bool, bool]:
        """(in_order, unicity) — identical to :func:`classify_edges`."""
        n = c.src_pts.shape[0]
        if n == 0:
            return True, True
        key = (c.producer, c.consumer, id(c.src_pts), id(c.dst_pts))
        hit = self._verdicts.get(key)
        # the Channel is pinned in the cache value, so the ids stay valid
        if hit is not None and hit[1].src_pts is c.src_pts:
            return hit[0]
        _, p_index, p_rank, p_injective = self._proc_data(c.producer)
        _, c_index, c_rank, _ = self._proc_data(c.consumer)
        src_rows = p_index.rows_of(c.src_pts)
        src_rank = p_rank[src_rows]
        dst_rank = c_rank[c_index.rows_of(c.dst_pts)]
        if bool(np.all(dst_rank[1:] >= dst_rank[:-1])):
            seq = src_rank        # edges already in consumer order (a stable
        else:                     # argsort of a sorted key is the identity)
            seq = src_rank[np.argsort(dst_rank, kind="stable")]
        in_order = bool(np.all(seq[1:] >= seq[:-1]))
        if p_injective:
            # distinct ranks == distinct rows — and the row multiset is
            # tiling-independent, so the count is computed once per channel
            unicity = self._distinct_sources(c, src_rows) == n
        else:
            unicity = len(np.unique(src_rank)) == n
        flags = (in_order, unicity)
        self._verdicts[key] = (flags, c)
        return flags

    def classify(self, c: Channel) -> Pattern:
        return Pattern.of(*self.edge_flags(c))


def _classify_channels(ppn: PPN, channels: Optional[Sequence[Channel]] = None,
                       classifier: Optional[ChannelClassifier] = None
                       ) -> Dict[str, Pattern]:
    clf = classifier if classifier is not None else ChannelClassifier(ppn)
    clf.ppn = ppn
    return {c.name: clf.classify(c)
            for c in (ppn.channels if channels is None else channels)}


@deprecated_shim("analyze(...).classify()")
def classify_channels(ppn: PPN, channels: Optional[Sequence[Channel]] = None,
                      classifier: Optional[ChannelClassifier] = None
                      ) -> Dict[str, Pattern]:
    """Classify every channel of ``ppn`` (or the given subset) in one batched
    pass; pass an existing ``classifier`` to share per-process work across
    calls (e.g. before/after a FIFOIZE rewrite)."""
    return _classify_channels(ppn, channels, classifier)


# ============================================================= symbolic side

@dataclass
class ProcSpace:
    """A process's iteration space with its (possibly tiled) local schedule,
    for symbolic reasoning."""

    dims: Tuple[str, ...]
    base: AffineSchedule
    tiling: Optional[Tiling] = None

    def timestamps(self, var_map: Mapping[str, str], uid: str
                   ) -> Tuple[List[LinExpr], List[Constraint]]:
        """Timestamp expressions after renaming dims via ``var_map``; tiled
        schedules introduce fresh φ variables (prefixed by ``uid``) with their
        definitional constraints."""
        renamed = [e.rename(dict(var_map)) for e in self.base.exprs]
        if self.tiling is None:
            return renamed, []
        new_dims = [var_map.get(d, d) for d in self.dims]
        phis, cons = self.tiling.tile_coord_exprs(new_dims, uid)
        return phis + renamed, cons


def _violation_setup(rel: Relation, prod: ProcSpace, cons_: ProcSpace,
                     assumptions: Iterable[Constraint]):
    """Shared construction for the violation systems: renamed relation pieces,
    the four timestamp vectors, and the auxiliary (φ-definition) constraints."""
    assumptions = list(assumptions)
    p1, a_vars, b_vars = rel.renamed_pieces("a_", "b_")   # x → x'
    p2, c_vars, d_vars = rel.renamed_pieces("c_", "d_")   # y → y'
    ts_b, aux_b = cons_.timestamps(dict(zip(cons_.dims, b_vars)), "tb_")
    ts_d, aux_d = cons_.timestamps(dict(zip(cons_.dims, d_vars)), "td_")
    ts_a, aux_a = prod.timestamps(dict(zip(prod.dims, a_vars)), "ta_")
    ts_c, aux_c = prod.timestamps(dict(zip(prod.dims, c_vars)), "tc_")
    aux = aux_a + aux_b + aux_c + aux_d
    return (assumptions, p1, p2, a_vars, c_vars, ts_a, ts_b, ts_c, ts_d, aux)


def _violations_empty(rel: Relation, prod: ProcSpace, cons_: ProcSpace,
                      assumptions: Iterable[Constraint], kind: str) -> bool:
    """Joint emptiness of the violation systems, checked *incrementally*.

    kind='in-order':  x' ≺C y'  ∧  y ≺P x     (violation of x ⪯P y)
    kind='unicity' :  x' ≺C y'  ∧  x = y      (same value, two reads)

    The ``base = poly1 ∩ poly2 ∩ assumptions ∩ aux`` prefix of every
    (k1, k2) system is built once per piece pair and only extended with the
    depth constraints; when a shallower prefix is already (rationally) empty
    every extension is empty too, so whole depth subtrees are skipped.  The
    polyhedron-level memo cache then collapses the remaining near-identical
    systems across the in-order and unicity passes.
    """
    (assumptions, p1, p2, a_vars, c_vars,
     ts_a, ts_b, ts_c, ts_d, aux) = _violation_setup(rel, prod, cons_,
                                                     assumptions)
    uniq = [eq(LinExpr.var(u), LinExpr.var(w))
            for u, w in zip(a_vars, c_vars)]
    for poly1 in p1:
        for poly2 in p2:
            base = poly1.intersect(poly2).intersect(assumptions).intersect(aux)
            if base.is_rationally_empty():
                continue                       # every extension is empty
            for k1 in range(1, len(ts_b) + 1):
                lhs = base.intersect(lex_lt_at_depth(ts_b, ts_d, k1))
                if kind == "in-order":
                    if len(ts_a) > 1 and lhs.is_rationally_empty():
                        continue               # skip the whole k2 subtree
                    for k2 in range(1, len(ts_a) + 1):
                        if not lhs.intersect(
                                lex_lt_at_depth(ts_c, ts_a, k2)).is_empty():
                            return False
                else:
                    if not lhs.intersect(uniq).is_empty():
                        return False
    return True


def violation_systems(rel: Relation, prod: ProcSpace, cons_: ProcSpace,
                      assumptions: Iterable[Constraint], kind: str):
    """Yield every fully-extended violation system as one `Polyhedron`.

    These are exactly the systems `_violations_empty` decides incrementally
    at a concrete size; the parametric prover materialises each whole and
    projects it onto the size parameters instead (`core.parametric`), so the
    construction lives here next to the incremental path it mirrors.
    """
    (assumptions, p1, p2, a_vars, c_vars,
     ts_a, ts_b, ts_c, ts_d, aux) = _violation_setup(rel, prod, cons_,
                                                     assumptions)
    uniq = [eq(LinExpr.var(u), LinExpr.var(w))
            for u, w in zip(a_vars, c_vars)]
    for poly1 in p1:
        for poly2 in p2:
            base = poly1.intersect(poly2).intersect(assumptions).intersect(aux)
            for k1 in range(1, len(ts_b) + 1):
                lhs = base.intersect(lex_lt_at_depth(ts_b, ts_d, k1))
                if kind == "in-order":
                    for k2 in range(1, len(ts_a) + 1):
                        yield lhs.intersect(lex_lt_at_depth(ts_c, ts_a, k2))
                else:
                    yield lhs.intersect(uniq)


def in_order_symbolic(rel: Relation, prod: ProcSpace, cons_: ProcSpace,
                      assumptions: Iterable[Constraint] = ()) -> bool:
    return _violations_empty(rel, prod, cons_, assumptions, "in-order")


def unicity_symbolic(rel: Relation, prod: ProcSpace, cons_: ProcSpace,
                     assumptions: Iterable[Constraint] = ()) -> bool:
    return _violations_empty(rel, prod, cons_, assumptions, "unicity")


def classify_symbolic(rel: Relation, prod: ProcSpace, cons_: ProcSpace,
                      assumptions: Iterable[Constraint] = ()) -> Pattern:
    return Pattern.of(in_order_symbolic(rel, prod, cons_, assumptions),
                      unicity_symbolic(rel, prod, cons_, assumptions))
