"""Integer polyhedra: Fourier–Motzkin elimination, emptiness, enumeration.

The paper reduces ``¬in-order`` and ``¬unicity`` to emptiness checks of convex
polyhedra (solvable by LP).  We implement:

* exact rational emptiness via Fourier–Motzkin (FM) elimination — sound and
  complete over Q; empty over Q ⇒ empty over Z (the direction that certifies
  a FIFO),
* an integer point search (FM bounds + backtracking substitution, i.e. the
  "easy path" of the Omega test) that certifies non-emptiness over Z,
* bounded enumeration used by the oracle backend and the sizing pass.

Everything is exact integer arithmetic.

The heavy operations (normalization, FM pos/neg/rest partitioning and pair
combination) run on a dense ``(n_rows × n_vars+1)`` int64 constraint matrix
(last column = constant) instead of per-row coefficient dicts; when a
combination could overflow int64 the matrix transparently widens to exact
Python-int (object dtype) arithmetic.  Emptiness verdicts are memoized on the
canonical form of the system (sorted variables, gcd-tightened, row-dominance
reduced, lexicographically sorted rows) so the classifier's many
near-identical violation systems are solved once.
"""
from __future__ import annotations

import itertools
import math
import os
import pickle
import tempfile
import weakref
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .affine import Constraint, LinExpr, ceil_div, floor_div

# A row is an inequality  sum(coeffs[v]*v) + const >= 0, stored as LinExpr.
Row = LinExpr


class FMBlowup(Exception):
    """Fourier–Motzkin row blow-up guard tripped; the (parametric) projection
    was abandoned rather than computed approximately."""

# int64 combination safety margin: |a*b + c*d| must stay below 2^63.
_INT64_SAFE = 1 << 62

# ------------------------------------------------------------------- memo ----
# Canonical-form verdict caches.  Keys derive from the *content* of a system
# (variables + normalized matrix bytes), so mutating a Polyhedron after a
# cached query cannot return a stale verdict — the key changes with it.
#
# Keys are two-level: ``(structure, consts)`` where ``structure`` is the
# canonical coefficient matrix (variables + coefficient bytes) and ``consts``
# the constant column as an int tuple.  Canonical systems have pairwise
# distinct coefficient rows (dominance keeps one row per coefficient vector)
# and are sorted by coefficient vector, so two systems sharing a structure
# align row-for-row and differ only in their constants — exactly how the
# classifier's violation systems vary across tile-size configurations.  A
# bounded side index per structure enables *monotone inference*: loosening a
# constant (larger c in ``expr + c ≥ 0``) only grows the feasible set, so a
# known non-empty sibling with pointwise-smaller constants certifies
# non-emptiness (and a known empty sibling with pointwise-larger constants
# certifies emptiness) without running Fourier–Motzkin at all.
_EMPTY_MEMO: Dict[object, bool] = {}
_POINT_MEMO: Dict[object, Optional[Dict[str, int]]] = {}
_BOX_MEMO: Dict[object, Dict[str, Tuple[int, int]]] = {}
_PROJ_MEMO: Dict[object, object] = {}
_EMPTY_STRUCT: Dict[object, List[Tuple[Tuple[int, ...], bool]]] = {}
_POINT_STRUCT: Dict[object, List[Tuple[Tuple[int, ...], Dict[str, int]]]] = {}
_MEMO_LIMIT = 1 << 17
_STRUCT_FANOUT = 16        # monotone entries kept/scanned per structure node
_MEMO_STATS = {"hits": 0, "misses": 0, "evictions": 0, "struct_hits": 0,
               "loaded": 0}


# ----------------------------------------------------------------- pinning ---
# A live symbolic (parametric) analysis keeps its template valid by replaying
# cached verdicts at evaluate() time, possibly long after the sweep that
# produced them.  A CachePin records every memo key touched while it is
# entered (as a context manager) and, for as long as the pin object is alive,
# the bounded half-eviction in `_memo_put` skips those keys.  Pins are held in
# a WeakSet so a dropped analysis releases its pins automatically.

_LIVE_PINS: "weakref.WeakSet[CachePin]" = weakref.WeakSet()
_RECORDING: List["CachePin"] = []


class CachePin:
    """Pins polyhedron-memo entries against eviction while alive.

    Use as a context manager around the queries whose verdicts must survive
    (``with pin: ...``); every key read or written inside is pinned until
    `release()` is called or the pin is garbage collected.
    """

    __slots__ = ("keys", "__weakref__")

    def __init__(self) -> None:
        self.keys: set = set()

    def __enter__(self) -> "CachePin":
        _RECORDING.append(self)
        return self

    def __exit__(self, *exc) -> None:
        try:
            _RECORDING.remove(self)
        except ValueError:
            pass

    def release(self) -> None:
        self.keys.clear()
        _LIVE_PINS.discard(self)


def polyhedron_cache_pin() -> CachePin:
    """A new live pin; see `CachePin`."""
    pin = CachePin()
    _LIVE_PINS.add(pin)
    return pin


def _pinned_keys() -> set:
    pinned: set = set()
    for pin in _LIVE_PINS:
        pinned |= pin.keys
    return pinned

#: bump when the key or value layout of the persistent store changes; files
#: with another version are silently ignored (the cache is safe to delete).
CACHE_VERSION = "repro-polyhedron-cache-v1"


def clear_polyhedron_cache() -> None:
    _EMPTY_MEMO.clear()
    _POINT_MEMO.clear()
    _BOX_MEMO.clear()
    _PROJ_MEMO.clear()
    _EMPTY_STRUCT.clear()
    _POINT_STRUCT.clear()
    for k in _MEMO_STATS:
        _MEMO_STATS[k] = 0


def polyhedron_cache_stats() -> Dict[str, int]:
    return dict(_MEMO_STATS,
                empty_entries=len(_EMPTY_MEMO),
                point_entries=len(_POINT_MEMO),
                box_entries=len(_BOX_MEMO),
                proj_entries=len(_PROJ_MEMO),
                pinned_keys=sum(len(p.keys) for p in _LIVE_PINS))


def _memo_get(memo: Dict, key):
    got = memo.get(key, _memo_get)
    if got is not _memo_get:
        _MEMO_STATS["hits"] += 1
        if _RECORDING:
            for pin in _RECORDING:
                pin.keys.add(key)
        return True, got
    _MEMO_STATS["misses"] += 1
    return False, None


def _memo_put(memo: Dict, key, value, struct: Optional[Dict] = None):
    if _RECORDING:
        for pin in _RECORDING:
            pin.keys.add(key)
    if len(memo) >= _MEMO_LIMIT:
        # bounded eviction: drop the oldest half (dict preserves insertion
        # order) instead of wiping the whole cache — the retained half keeps
        # long-running sweeps warm across the limit.  Keys pinned by a live
        # symbolic analysis are skipped so its template verdicts stay warm;
        # if everything in the oldest half is pinned the memo simply grows
        # past the limit until the pins are released.
        drop = max(1, len(memo) // 2)
        pinned = _pinned_keys() if _LIVE_PINS else ()
        dropped = 0
        for k in list(iter(memo)):
            if dropped >= drop:
                break
            if k in pinned:
                continue
            del memo[k]
            dropped += 1
        _MEMO_STATS["evictions"] += dropped
        if struct is not None:
            struct.clear()      # lossy side index; rebuild from later queries
    memo[key] = value


def _struct_add(struct: Dict, skey, consts: Tuple[int, ...], value) -> None:
    node = struct.setdefault(skey, [])
    if len(node) >= _STRUCT_FANOUT:
        node.pop(0)
    node.append((consts, value))


def _struct_probe_empty(skey, consts: Tuple[int, ...]) -> Optional[bool]:
    """Monotone inference over siblings sharing the coefficient structure."""
    for c2, empty2 in _EMPTY_STRUCT.get(skey, ()):
        if len(c2) != len(consts):
            continue
        if empty2:
            if all(a <= b for a, b in zip(consts, c2)):
                return True        # tighter than a known-empty sibling
        else:
            if all(a >= b for a, b in zip(consts, c2)):
                return False       # looser than a known-non-empty sibling
    return None


def _struct_probe_point(skey, consts: Tuple[int, ...]
                        ) -> Optional[Dict[str, int]]:
    """A sibling's integer point stays valid when every constant loosened."""
    for c2, pt in _POINT_STRUCT.get(skey, ()):
        if len(c2) == len(consts) and all(a >= b
                                          for a, b in zip(consts, c2)):
            return pt
    return None


# ------------------------------------------------------- persistent store ----

def export_polyhedron_cache() -> Dict[str, object]:
    """Snapshot of the verdict caches (picklable, version-tagged).  Used both
    by the on-disk persistence below and by the sweep engine's process-pool
    driver to merge worker caches back into the parent."""
    return {"version": CACHE_VERSION,
            "empty": list(_EMPTY_MEMO.items()),
            "point": list(_POINT_MEMO.items()),
            "box": list(_BOX_MEMO.items())}


def merge_polyhedron_cache(snapshot: Mapping[str, object]) -> int:
    """Adopt entries from an `export_polyhedron_cache` snapshot; returns the
    number of new entries.  Unknown versions are ignored (returns 0)."""
    if (not isinstance(snapshot, Mapping)
            or snapshot.get("version") != CACHE_VERSION):
        return 0
    adopted = 0
    for name, memo, struct in (("empty", _EMPTY_MEMO, _EMPTY_STRUCT),
                               ("point", _POINT_MEMO, _POINT_STRUCT),
                               ("box", _BOX_MEMO, None)):
        for key, value in snapshot.get(name, ()):
            if key not in memo:
                _memo_put(memo, key, value, struct)
                adopted += 1
    _MEMO_STATS["loaded"] += adopted
    return adopted


def save_polyhedron_cache(path: str) -> int:
    """Write the verdict caches to ``path`` (atomic rename).  The file is a
    pure cache: versioned, safe to delete, rebuilt on demand.  Returns the
    number of entries written."""
    snapshot = export_polyhedron_cache()
    n = sum(len(snapshot[k]) for k in ("empty", "point", "box"))
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(snapshot, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return n


def peek_polyhedron_cache(path: str) -> Optional[Dict[str, int]]:
    """Version + per-memo entry counts of a `save_polyhedron_cache` file
    WITHOUT merging it (the `repro.dse status` / artifact-store probe).
    Returns None for missing/corrupt/version-mismatched files — the same
    cases `load_polyhedron_cache` treats as a cold start."""
    try:
        with open(path, "rb") as fh:
            snapshot = pickle.load(fh)
        if (not isinstance(snapshot, Mapping)
                or snapshot.get("version") != CACHE_VERSION):
            return None
        return {"version": snapshot["version"],
                **{k: len(snapshot.get(k, ())) for k in ("empty", "point",
                                                         "box")}}
    except Exception:
        return None


def load_polyhedron_cache(path: str) -> int:
    """Merge a `save_polyhedron_cache` file into the in-memory caches.
    Missing, corrupt, or version-mismatched files are ignored (returns 0) —
    deleting the cache is always safe.  Only load files you wrote: the store
    is a local pickle, not an interchange format."""
    try:
        with open(path, "rb") as fh:
            snapshot = pickle.load(fh)
        return merge_polyhedron_cache(snapshot)
    except Exception:
        # a cache must never take the process down: any malformed file —
        # unreadable, truncated, or a same-version snapshot with mangled
        # fields — just means a cold start
        return 0


# ---------------------------------------------------------- matrix helpers ---

def _rows_to_matrix(rows: Sequence[Row]) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Dense ``(n_rows × n_vars+1)`` constraint matrix (last column const).

    Variables are interned in first-appearance order.  Values exceeding the
    int64 combination-safety margin force the exact object-dtype fallback.
    """
    index: Dict[str, int] = {}
    for r in rows:
        for name in r.coeffs:
            if name not in index:
                index[name] = len(index)
    nv = len(index)
    data = [[0] * (nv + 1) for _ in rows]
    big = False
    for i, r in enumerate(rows):
        row = data[i]
        for name, c in r.coeffs.items():
            row[index[name]] = c
            big = big or abs(c) >= _INT64_SAFE
        row[nv] = r.const
        big = big or abs(r.const) >= _INT64_SAFE
    dtype = object if big else np.int64
    mat = np.array(data, dtype=dtype)
    if mat.size == 0:
        mat = mat.reshape(len(rows), nv + 1)
    return tuple(index), mat


def _matrix_to_rows(variables: Sequence[str], mat: np.ndarray) -> List[Row]:
    out: List[Row] = []
    for row in mat:
        coeffs = {v: int(c) for v, c in zip(variables, row[:-1]) if c != 0}
        out.append(LinExpr(coeffs, int(row[-1])))
    return out


def _row_gcds(coeffs: np.ndarray) -> np.ndarray:
    """Per-row gcd of |coefficients| (0 for all-zero rows)."""
    if coeffs.dtype == object:
        return np.array([math.gcd(*[abs(int(c)) for c in row]) if len(row)
                         else 0 for row in coeffs], dtype=object)
    if coeffs.shape[1] == 0:
        return np.zeros(coeffs.shape[0], dtype=np.int64)
    return np.gcd.reduce(np.abs(coeffs), axis=1)


def _lexsort_rows(mat: np.ndarray) -> np.ndarray:
    """Row order sorting by (coeff₀, coeff₁, …, const) ascending."""
    if mat.dtype == object:
        return np.array(sorted(range(mat.shape[0]),
                               key=lambda i: tuple(int(x) for x in mat[i])),
                        dtype=np.intp)
    # np.lexsort: last key is primary ⇒ feed columns right-to-left.
    return np.lexsort(mat[:, ::-1].T)


def _normalize_matrix(mat: np.ndarray) -> Optional[np.ndarray]:
    """Vectorized normalization: gcd-tighten each row, drop trivial rows,
    eliminate syntactically dominated rows (same coefficient vector ⇒ keep
    only the tightest constant), and sort rows canonically.

    Returns None if a trivially unsatisfiable row (0 ≥ -c, c > 0) is found.
    """
    if mat.shape[0] == 0:
        return mat
    coeffs = mat[:, :-1]
    g = _row_gcds(coeffs)
    zero = g == 0
    if bool(np.any(zero)):
        if bool(np.any(mat[zero, -1] < 0)):
            return None                   # "c >= 0" with c < 0: empty
        mat = mat[~zero]
        g = g[~zero]
        if mat.shape[0] == 0:
            return mat
    tighten = g > 1
    if bool(np.any(tighten)):
        mat = mat.copy()
        mat[tighten, :-1] //= g[tighten, None]
        # integer tightening of the constant: g·x + c ≥ 0 ⇔ x + ⌊c/g⌋ ≥ 0
        mat[tighten, -1] = np.floor_divide(mat[tighten, -1], g[tighten])
    order = _lexsort_rows(mat)
    mat = mat[order]
    # dominance: rows sharing a coefficient vector are sorted by const
    # ascending, and the smallest const is the tightest bound — keep it only.
    if mat.shape[0] > 1:
        distinct = np.any(mat[1:, :-1] != mat[:-1, :-1], axis=1)
        keep = np.concatenate([[True], distinct])
        mat = mat[keep]
    return mat


def _fm_eliminate_matrix(mat: np.ndarray, col: int) -> Optional[np.ndarray]:
    """Eliminate variable ``col`` (rational projection) on the matrix form."""
    c = mat[:, col]
    pos_mask = c > 0
    neg_mask = c < 0
    pos = mat[pos_mask]
    neg = mat[neg_mask]
    rest = mat[~pos_mask & ~neg_mask]
    if pos.shape[0] and neg.shape[0]:
        if mat.dtype != object:
            # |comb| ≤ max|pos|·max(cn) + max|neg|·max(cp): widen when unsafe.
            bound = (int(np.abs(pos).max()) * int((-neg[:, col]).max())
                     + int(np.abs(neg).max()) * int(pos[:, col].max()))
            if bound >= _INT64_SAFE:
                pos, neg, rest = (pos.astype(object), neg.astype(object),
                                  rest.astype(object))
        cp = pos[:, col]
        cn = -neg[:, col]
        comb = (pos[:, None, :] * cn[None, :, None]
                + neg[None, :, :] * cp[:, None, None])
        comb = comb.reshape(-1, mat.shape[1])
        rest = np.concatenate([rest, comb], axis=0)
    return _normalize_matrix(rest)


def _elimination_order(mat: np.ndarray) -> List[int]:
    """Columns ordered by occupancy (fewest mentioning rows first)."""
    occupancy = (mat[:, :-1] != 0).sum(axis=0)
    return [int(j) for j in np.argsort(occupancy, kind="stable")
            if occupancy[j] > 0]


class Polyhedron:
    """Conjunction of affine inequalities over named integer variables.

    Equalities are stored as two inequalities.  Variables not mentioned in any
    row are unconstrained.
    """

    def __init__(self, constraints: Iterable[Constraint] = ()):
        self.rows: List[Row] = []
        for c in constraints:
            self.add(c)

    # ------------------------------------------------------------------ build
    def add(self, c: Constraint) -> "Polyhedron":
        if c.is_eq:
            self.rows.append(c.expr)
            self.rows.append(-c.expr)
        else:
            self.rows.append(c.expr)
        return self

    def copy(self) -> "Polyhedron":
        p = Polyhedron()
        p.rows = list(self.rows)
        return p

    def intersect(self, other: "Polyhedron | Iterable[Constraint]") -> "Polyhedron":
        p = self.copy()
        if isinstance(other, Polyhedron):
            p.rows.extend(other.rows)
        else:
            for c in other:
                p.add(c)
        return p

    def rename(self, mapping: Mapping[str, str]) -> "Polyhedron":
        p = Polyhedron()
        p.rows = [r.rename(mapping) for r in self.rows]
        return p

    def substitute(self, env: Mapping[str, LinExpr | int]) -> "Polyhedron":
        p = Polyhedron()
        p.rows = [r.substitute(env) for r in self.rows]
        return p

    def vars(self) -> Tuple[str, ...]:
        seen: Dict[str, None] = {}
        for r in self.rows:
            for v in r.coeffs:
                seen.setdefault(v)
        return tuple(seen)

    def contains(self, env: Mapping[str, int]) -> bool:
        return all(r.eval(env) >= 0 for r in self.rows)

    # ------------------------------------------------------------ matrix form
    def to_matrix(self) -> Tuple[Tuple[str, ...], np.ndarray]:
        """(variables, constraint matrix) — last column is the constant."""
        return _rows_to_matrix(self.rows)

    @staticmethod
    def from_matrix(variables: Sequence[str], mat: np.ndarray) -> "Polyhedron":
        p = Polyhedron()
        p.rows = _matrix_to_rows(variables, mat)
        return p

    def _canonical(self) -> Tuple[Tuple[str, ...], Optional[np.ndarray]]:
        """Canonical (sorted-variable, normalized, row-sorted) form; the
        matrix is None when the system is trivially empty."""
        variables, mat = self.to_matrix()
        if variables:
            perm = sorted(range(len(variables)), key=lambda i: variables[i])
            variables = tuple(variables[i] for i in perm)
            mat = mat[:, perm + [len(perm)]]
        return variables, _normalize_matrix(mat)

    @staticmethod
    def _memo_key(variables: Tuple[str, ...], mat: np.ndarray):
        """``((variables, coeff-structure), consts)`` — the canonical matrix
        split into its coefficient structure and constant column, so systems
        differing only in constants (e.g. across tile-size configurations)
        share a structure node for monotone inference."""
        consts = tuple(int(x) for x in mat[:, -1])
        if mat.dtype == object:
            body = tuple(tuple(int(x) for x in row[:-1]) for row in mat)
        else:
            coeff = np.ascontiguousarray(mat[:, :-1])
            body = (coeff.shape, coeff.tobytes())
        return (variables, body), consts

    # --------------------------------------------------------- normalization
    @staticmethod
    def _normalize_rows(rows: List[Row]) -> Optional[List[Row]]:
        """gcd-tighten rows, drop duplicates/trivial; None if trivially empty."""
        out: Dict[Tuple, Row] = {}
        for r in rows:
            r = r.content_normalized()
            if not r.coeffs:
                if r.const < 0:
                    return None          # "c >= 0" with c < 0: empty
                continue                 # trivially true
            key = tuple(sorted(r.coeffs.items()))
            prev = out.get(key)
            # keep the tightest constant (larger const ⇒ weaker "expr+const>=0"?
            # expr + const >= 0: smaller const is tighter)
            if prev is None or r.const < prev.const:
                out[key] = r
        return list(out.values())

    # ---------------------------------------------------- Fourier–Motzkin
    def project_out(self, variables: Sequence[str]) -> Optional["Polyhedron"]:
        names, mat = self.to_matrix()
        mat = _normalize_matrix(mat)
        if mat is None:
            return None
        col_of = {v: j for j, v in enumerate(names)}
        for var in variables:
            if var not in col_of:
                continue
            mat = _fm_eliminate_matrix(mat, col_of[var])
            if mat is None:
                return None
        drop = set(variables)
        keep = [v for v in names if v not in drop]
        keep_cols = [col_of[v] for v in keep] + [len(names)]
        return Polyhedron.from_matrix(keep, mat[:, keep_cols])

    def project_onto(self, keep: Sequence[str],
                     max_rows: int = 4000) -> Optional["Polyhedron"]:
        """Parametric projection: FM-eliminate every variable *not* in
        ``keep``, leaving a system over the kept columns only.

        This is the parametric-polyhedron entry point: when ``keep`` is the
        set of symbolic size parameters, the parameters ride through the
        elimination as ordinary columns and the result characterises exactly
        the parameter values for which the original system is rationally
        non-empty (FM is complete over Q).

        Returns None when the system is empty for *all* parameter values.
        Raises `FMBlowup` when the row count exceeds ``max_rows`` mid-way —
        callers must treat that as "undecided", never as a verdict.

        Memoized with the same two-level ``(structure × constants)`` key as
        the emptiness caches, extended with the kept-variable set.
        """
        cvars, mat = self._canonical()
        if mat is None:
            return None
        keep_set = frozenset(keep)
        skey, consts = Polyhedron._memo_key(cvars, mat)
        key = ((skey, tuple(sorted(keep_set))), consts)
        hit, cached = _memo_get(_PROJ_MEMO, key)
        if hit:
            if cached is None:
                return None
            kept, pmat = cached
            return Polyhedron.from_matrix(kept, pmat)
        col_of = {v: j for j, v in enumerate(cvars)}
        elim = [j for v, j in col_of.items() if v not in keep_set]
        work = mat
        while True:
            if work.shape[0] == 0:
                break
            occ = (work[:, :-1] != 0).sum(axis=0)
            cand = [j for j in elim if occ[j] > 0]
            if not cand:
                break
            j = min(cand, key=lambda j: int(occ[j]))
            work = _fm_eliminate_matrix(work, j)
            if work is None:
                _memo_put(_PROJ_MEMO, key, None)
                return None
            if work.shape[0] > max_rows:
                raise FMBlowup(
                    f"parametric projection exceeded {max_rows} rows")
        kept = tuple(v for v in cvars if v in keep_set)
        cols = [col_of[v] for v in kept] + [len(cvars)]
        pmat = work[:, cols]
        _memo_put(_PROJ_MEMO, key, (kept, pmat))
        return Polyhedron.from_matrix(kept, pmat)

    def is_rationally_empty(self) -> bool:
        """Exact emptiness over Q (FM is complete over the rationals)."""
        variables, mat = self._canonical()
        if mat is None:
            return True
        return Polyhedron._rationally_empty_canonical(variables, mat)

    @staticmethod
    def _rationally_empty_canonical(variables: Tuple[str, ...],
                                    mat: np.ndarray) -> bool:
        skey, consts = Polyhedron._memo_key(variables, mat)
        key = (skey, consts)
        hit, cached = _memo_get(_EMPTY_MEMO, key)
        if hit:
            return cached
        inferred = _struct_probe_empty(skey, consts)
        if inferred is not None:
            _MEMO_STATS["struct_hits"] += 1
            _memo_put(_EMPTY_MEMO, key, inferred, _EMPTY_STRUCT)
            return inferred
        result = False
        complete = True
        for col in _elimination_order(mat):
            mat = _fm_eliminate_matrix(mat, col)
            if mat is None:
                result = True
                break
            if mat.shape[0] > 4000:   # FM blow-up guard; fall back conservative
                complete = False
                break
        _memo_put(_EMPTY_MEMO, key, result, _EMPTY_STRUCT)
        if complete:
            # only exact verdicts feed the monotone index — a guard-tripped
            # "conservatively non-empty" must not certify looser siblings
            _struct_add(_EMPTY_STRUCT, skey, consts, result)
        return result

    # --------------------------------------------------------- integer search
    def _var_bounds(self, rows: List[Row], var: str) -> Tuple[Optional[int], Optional[int]]:
        """Bounds on var implied by rows mentioning only var (after elimination
        of all other variables)."""
        lo: Optional[int] = None
        hi: Optional[int] = None
        for r in rows:
            c = r.coeffs.get(var, 0)
            if c == 0 or len(r.coeffs) != 1:
                continue
            # c*var + const >= 0
            if c > 0:
                b = ceil_div(-r.const, c)
                lo = b if lo is None else max(lo, b)
            else:
                b = floor_div(r.const, -c)
                hi = b if hi is None else min(hi, b)
        return lo, hi

    def find_integer_point(self, max_nodes: int = 50000,
                           default_radius: int = 64) -> Optional[Dict[str, int]]:
        """Search for an integer point; None if none found.

        Strategy: FM-derived static bounding box per variable, then DFS with
        dynamic most-constrained-variable-first ordering and constraint
        propagation (windows re-tightened from every row whose other
        variables are already assigned).  Equalities and the floor-div rows of
        tile coordinates collapse to single-value windows as soon as their
        defining variables are set, so the search degenerates to enumerating
        only the genuinely free dimensions."""
        cvars, cmat = self._canonical()
        if cmat is None:
            return None
        return Polyhedron._find_integer_point_canonical(cvars, cmat, max_nodes,
                                                        default_radius)

    @staticmethod
    def _find_integer_point_canonical(cvars: Tuple[str, ...], cmat: np.ndarray,
                                      max_nodes: int, default_radius: int
                                      ) -> Optional[Dict[str, int]]:
        skey, consts = Polyhedron._memo_key(cvars, cmat)
        skey = (skey, max_nodes, default_radius)
        memo_key = (skey, consts)
        hit, cached = _memo_get(_POINT_MEMO, memo_key)
        if hit:
            return dict(cached) if cached is not None else None
        rows = _matrix_to_rows(cvars, cmat)
        candidate = _struct_probe_point(skey, consts)
        if candidate is not None and all(r.eval(candidate) >= 0 for r in rows):
            # a sibling's point, re-verified against THESE constants (the
            # monotone argument guarantees it, the evaluation costs nothing)
            _MEMO_STATS["struct_hits"] += 1
            _memo_put(_POINT_MEMO, memo_key, dict(candidate), _POINT_STRUCT)
            return dict(candidate)
        variables = list({v: None for r in rows for v in r.coeffs})
        if not variables:
            _memo_put(_POINT_MEMO, memo_key, {}, _POINT_STRUCT)
            return {}

        budget = [max_nodes]

        def window(var: str, env: Dict[str, int]) -> Optional[Tuple[int, int]]:
            lo: Optional[int] = None
            hi: Optional[int] = None
            for r in rows:
                c = r.coeffs.get(var, 0)
                if c == 0:
                    continue
                acc = r.const
                ok = True
                for w, cw in r.coeffs.items():
                    if w == var:
                        continue
                    if w in env:
                        acc += cw * env[w]
                    else:
                        ok = False
                        break
                if not ok:
                    continue
                # c*var + acc >= 0
                if c > 0:
                    b = ceil_div(-acc, c)
                    lo = b if lo is None else max(lo, b)
                else:
                    b = floor_div(acc, -c)
                    hi = b if hi is None else min(hi, b)
                if lo is not None and hi is not None and lo > hi:
                    return None
            if lo is None and hi is None:
                lo, hi = -default_radius, default_radius
            elif lo is None:
                lo = hi - 2 * default_radius
            elif hi is None:
                hi = lo + 2 * default_radius
            return lo, hi

        def dfs(env: Dict[str, int]) -> Optional[Dict[str, int]]:
            if budget[0] <= 0:
                return None
            budget[0] -= 1
            unassigned = [v_ for v_ in variables if v_ not in env]
            if not unassigned:
                return dict(env) if all(r.eval(env) >= 0 for r in rows) else None
            # most-constrained first
            best_var, best_win = None, None
            for var in unassigned:
                win = window(var, env)
                if win is None:
                    return None
                if best_win is None or (win[1] - win[0]) < (best_win[1] - best_win[0]):
                    best_var, best_win = var, win
                    if win[0] == win[1]:
                        break
            for val in range(best_win[0], best_win[1] + 1):
                env[best_var] = val
                got = dfs(env)
                if got is not None:
                    return got
                del env[best_var]
                if budget[0] <= 0:
                    return None
            return None

        found = dfs({})
        _memo_put(_POINT_MEMO, memo_key,
                  dict(found) if found is not None else None, _POINT_STRUCT)
        if found is not None:
            # negative results are budget-bounded, only found points are
            # portable to looser siblings
            _struct_add(_POINT_STRUCT, skey, consts, dict(found))
        return found

    def is_empty(self, max_nodes: int = 20000) -> bool:
        """Integer emptiness: rationally empty ⇒ empty; otherwise try to
        exhibit an integer point.  If the bounded search finds none we report
        empty — for the bounded-coefficient, box-bounded violation sets built
        by the classifier the guided search is exhaustive within the FM
        bounds, so this is exact in practice (cross-validated against the
        enumeration oracle in tests)."""
        variables, mat = self._canonical()       # canonicalize once, use twice
        if mat is None:
            return True
        if Polyhedron._rationally_empty_canonical(variables, mat):
            return True
        return Polyhedron._find_integer_point_canonical(
            variables, mat, max_nodes, 64) is None

    # ------------------------------------------------------------ enumeration
    def bounding_box(self) -> Dict[str, Tuple[int, int]]:
        """Per-variable integer bounds via FM projection; raises if unbounded.

        Memoized on the canonical form (FM projection is exact over Q
        whatever the elimination order, so the box is content-determined);
        the persistent store keeps domain enumeration warm across runs.
        """
        variables = self.vars()
        cvars, cmat = self._canonical()
        if cmat is None:
            return {v: (0, -1) for v in variables}       # trivially empty
        key = Polyhedron._memo_key(cvars, cmat)
        hit, cached = _memo_get(_BOX_MEMO, key)
        if hit:
            return dict(cached)
        box: Dict[str, Tuple[int, int]] = {}
        for var in variables:
            others = [w for w in variables if w != var]
            proj = self.project_out(others)
            if proj is None:
                box = {v: (0, -1) for v in variables}    # empty box
                _memo_put(_BOX_MEMO, key, dict(box))
                return box
            lo, hi = self._var_bounds(proj.rows, var)
            if lo is None or hi is None:
                raise ValueError(f"variable {var} unbounded; cannot enumerate")
            box[var] = (lo, hi)
        _memo_put(_BOX_MEMO, key, dict(box))
        return box

    def enumerate_points(self, max_points: int = 2_000_000) -> List[Dict[str, int]]:
        variables = self.vars()
        if not variables:
            return [{}] if Polyhedron._normalize_rows(self.rows) is not None else []
        box = self.bounding_box()
        total = 1
        for lo, hi in box.values():
            total *= max(0, hi - lo + 1)
        if total > max_points:
            raise ValueError(f"box too large to enumerate ({total} candidates)")
        out = []
        ranges = [range(box[v][0], box[v][1] + 1) for v in variables]
        for point in itertools.product(*ranges):
            env = dict(zip(variables, point))
            if self.contains(env):
                out.append(env)
        return out

    def __repr__(self) -> str:
        return "Polyhedron{" + " ∧ ".join(f"{r} >= 0" for r in self.rows) + "}"
