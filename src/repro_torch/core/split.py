"""The paper's contribution: SPLIT + FIFOIZE (Fig. 2).

    SPLIT(→c, θP, θC):
        for k := 1 to n:  ADD(→c ∩ {(x,y) : θP(x) ≪ᵏ θC(y)})
        ADD(→c ∩ {(x,y) : θP(x) ≈ⁿ θC(y)})

    FIFOIZE((P, C)):
        for each channel c (producer and consumer tiled with the same n,
                            schedule shape θ(φ₁..φₙ, i) = (φ₁..φₙ, i)):
            {→c¹ … →cⁿ⁺¹} := SPLIT(→c, θPc, θCc)
            if fifo(→cᵏ) ∀k:  REMOVE(→c); INSERT(→cᵏ ∀k)

Depth-k parts hold the dependences whose producer/consumer *tile coordinates*
first differ at depth k (k ≤ n), the (n+1)-th part the intra-tile dependences.
Empty parts are dropped.  A channel is replaced only when **all** its parts
are FIFO — the paper's criterion.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from .affine import Constraint
from .deprecation import deprecated_shim
from .patterns import (ChannelClassifier, Pattern, ProcSpace,
                       _classify_channels, classify_symbolic)
from .ppn import PPN, Channel, Process
from .relation import Relation
from .schedule import lex_lt_at_depth, prefix_eq


# ======================================================= enumeration backend

class NotApplicable(Exception):
    """SPLIT's coverage assumption fails for this channel (paper line 6:
    'If not, the next channel →c is considered')."""


def _endpoint_rows_and_phi(ppn: PPN, proc_name: str, pts: np.ndarray):
    """(domain rows or None, φ) of channel endpoints.  Endpoints that lie on
    the process domain (always, for dataflow-built channels) gather the
    memoized per-domain φ through the memoized row lookup — in a tile sweep
    this reuses work across the classify/fifoize/size stages AND across
    configurations; synthetic off-domain endpoints fall back to a direct
    tile-coordinate evaluation."""
    proc = ppn.processes[proc_name]
    try:
        rows = proc.domain_index().rows_of(pts)
    except KeyError:
        return None, proc.tiling.tile_coords_of(pts)
    return rows, proc.domain_tile_coords(ppn.params)[rows]


def split_channel(ppn: PPN, c: Channel) -> List[Channel]:
    """SPLIT on the edge-list form: partition edges by the first depth at
    which producer/consumer tile coordinates differ."""
    prod = ppn.processes[c.producer]
    cons = ppn.processes[c.consumer]
    if prod.tiling is None or cons.tiling is None:
        raise NotApplicable(f"{c.name}: both endpoints must be tiled")
    if prod.tiling.n != cons.tiling.n:
        raise NotApplicable(f"{c.name}: endpoint tilings must share depth")
    n = prod.tiling.n
    src_rows, sphi = _endpoint_rows_and_phi(ppn, c.producer, c.src_pts)  # E × n
    dst_rows, dphi = _endpoint_rows_and_phi(ppn, c.consumer, c.dst_pts)
    diff = sphi != dphi
    first = np.where(diff.any(axis=1), diff.argmax(axis=1), n)   # 0-based; n ⇒ same tile
    # Coverage: the ≪¹..≪ⁿ/≈ⁿ pieces only cover θP(x) ⪯ θC(y); a dependence
    # with θP(x) ≫ θC(y) in tile space means P and C do not share the
    # assumed (φ, i) schedule shape for this channel → not applicable.
    rows = np.arange(len(first))
    crossing = first < n
    if crossing.any():
        bad = sphi[rows[crossing], first[crossing]] > dphi[rows[crossing], first[crossing]]
        if bad.any():
            raise NotApplicable(f"{c.name}: tile-space order not producer≤consumer")
    parts: List[Channel] = []
    for k in range(n + 1):
        mask = first == k
        if not mask.any():
            continue          # drop empty parts
        part = replace(c, src_pts=c.src_pts[mask], dst_pts=c.dst_pts[mask],
                       depth=k + 1)
        # parts slice their parent's already-resolved domain rows — seed the
        # lookup memo so classifying/sizing the parts skips the row search
        if src_rows is not None:
            prod.domain_index().prime(part.src_pts, src_rows[mask])
        if dst_rows is not None:
            cons.domain_index().prime(part.dst_pts, dst_rows[mask])
        parts.append(part)
    return parts


@dataclass
class FifoizeReport:
    before: Dict[str, Pattern]
    after: Dict[str, Pattern]
    split_ok: List[str]              # channels replaced by all-FIFO partitions
    split_failed: List[str]          # split attempted, some part non-FIFO
    untouched: List[str]             # already-FIFO, untiled, or not applicable


def _fifoize(ppn: PPN, classifier: Optional[ChannelClassifier] = None
             ) -> Tuple[PPN, FifoizeReport]:
    clf = classifier if classifier is not None else ChannelClassifier(ppn)
    before = _classify_channels(ppn, classifier=clf)
    new_channels: List[Channel] = []
    ok: List[str] = []
    failed: List[str] = []
    untouched: List[str] = []
    for c in ppn.channels:
        if before[c.name] is Pattern.FIFO:
            untouched.append(c.name)
            new_channels.append(c)
            continue
        try:
            parts = split_channel(ppn, c)
        except NotApplicable:
            untouched.append(c.name)
            new_channels.append(c)
            continue
        if all(clf.classify(p) is Pattern.FIFO for p in parts):
            ok.append(c.name)
            new_channels.extend(parts)
        else:
            failed.append(c.name)
            new_channels.append(c)
    out = PPN(ppn.kernel_name, ppn.params, ppn.processes, new_channels)
    after = _classify_channels(out, classifier=clf)
    return out, FifoizeReport(before, after, ok, failed, untouched)


@deprecated_shim("analyze(...).fifoize()")
def fifoize(ppn: PPN, classifier: Optional[ChannelClassifier] = None
            ) -> Tuple[PPN, FifoizeReport]:
    """FIFOIZE: returns the rewritten PPN + a report (non-destructive).

    Channels already classified FIFO are left alone (splitting them would
    only multiply channel count — cf. gesummv in Table 2, unchanged at 6
    channels); channels violating the shared-(φ,i)-schedule assumption are
    skipped (paper line 6).  Classification runs on the batched
    per-process-rank path; pass an existing ``classifier`` to share its
    per-process caches with surrounding analyses."""
    return _fifoize(ppn, classifier)


def split_by_tile_pair(ppn: PPN, ch: Channel) -> List[Channel]:
    """Beyond-paper extension: partition by (φ_producer, φ_consumer) VALUE
    (not just crossing depth).  Needed when a process interleaves tiles
    instead of executing them atomically (vpp chunk interleaving) — the
    paper's ≈ⁿ part then still mixes tiles.  Recovers per-chunk FIFO
    channels, i.e. derives Megatron's separate per-chunk send/recv streams
    automatically."""
    prod = ppn.processes[ch.producer]
    cons = ppn.processes[ch.consumer]
    if prod.tiling is None or cons.tiling is None:
        raise NotApplicable(ch.name)
    src_rows, sphi = _endpoint_rows_and_phi(ppn, ch.producer, ch.src_pts)
    dst_rows, dphi = _endpoint_rows_and_phi(ppn, ch.consumer, ch.dst_pts)
    keys = np.concatenate([sphi, dphi], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    parts = []
    for g in range(len(uniq)):
        mask = inv == g
        part = replace(ch, src_pts=ch.src_pts[mask],
                       dst_pts=ch.dst_pts[mask], depth=g + 1)
        if src_rows is not None:
            prod.domain_index().prime(part.src_pts, src_rows[mask])
        if dst_rows is not None:
            cons.domain_index().prime(part.dst_pts, dst_rows[mask])
        parts.append(part)
    return parts


# ========================================================= symbolic backend

def split_relation(rel: Relation, prod: ProcSpace, cons_: ProcSpace,
                   assumptions: Iterable[Constraint] = ()
                   ) -> List[Tuple[int, Relation]]:
    """Symbolic SPLIT: intersect →c with θP(x) ≪ᵏ θC(y) / θP(x) ≈ⁿ θC(y)
    where the compared prefixes are the tile coordinates.  ``assumptions``
    bound the structure parameters (needed for exact integer emptiness)."""
    assert prod.tiling is not None and cons_.tiling is not None
    assert prod.tiling.n == cons_.tiling.n
    n = prod.tiling.n
    assumptions = list(assumptions)
    phi_p, cons_p = prod.tiling.tile_coord_exprs(
        [d for d in rel.in_vars], "sp_")
    phi_c, cons_c = cons_.tiling.tile_coord_exprs(
        [d for d in rel.out_vars], "sc_")
    aux = cons_p + cons_c
    parts: List[Tuple[int, Relation]] = []
    for k in range(1, n + 1):
        cs = aux + lex_lt_at_depth(phi_p, phi_c, k)
        parts.append((k, rel.intersected(cs)))
    parts.append((n + 1, rel.intersected(aux + prefix_eq(phi_p, phi_c, n))))
    return [(k, r) for k, r in parts
            if not r.intersected(assumptions).is_empty()]


def split_covers(rel: Relation, prod: ProcSpace, cons_: ProcSpace,
                 assumptions: Iterable[Constraint] = ()) -> bool:
    """Check the paper's applicability assumption symbolically: no dependence
    may have its producer tile *after* its consumer tile."""
    assert prod.tiling is not None and cons_.tiling is not None
    n = prod.tiling.n
    assumptions = list(assumptions)
    phi_p, cons_p = prod.tiling.tile_coord_exprs([d for d in rel.in_vars], "sp_")
    phi_c, cons_c = cons_.tiling.tile_coord_exprs([d for d in rel.out_vars], "sc_")
    aux = cons_p + cons_c
    for k in range(1, n + 1):
        bad = rel.intersected(aux + lex_lt_at_depth(phi_c, phi_p, k))
        if not bad.intersected(assumptions).is_empty():
            return False
    return True


def fifoize_relation(rel: Relation, prod: ProcSpace, cons_: ProcSpace,
                     assumptions: Iterable[Constraint] = ()
                     ) -> Optional[List[Tuple[int, Relation, Pattern]]]:
    """Symbolic FIFOIZE for one channel: the split parts with their patterns
    if *all* parts are FIFO, else None (channel kept as-is)."""
    if not split_covers(rel, prod, cons_, assumptions):
        return None
    parts = split_relation(rel, prod, cons_, assumptions)
    classified = [(k, r, classify_symbolic(r, prod, cons_, assumptions))
                  for k, r in parts]
    if all(p is Pattern.FIFO for _, _, p in classified):
        return classified
    return None
