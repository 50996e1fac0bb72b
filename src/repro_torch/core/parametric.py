"""Parametric (symbolic-size) analysis: prove once, evaluate per size in µs.

``analyze(kernel, sizes=symbolic)`` returns a `ParametricAnalysis`: the same
staged API as the concrete driver (`classify`/`fifoize`/`size`/`plan`), but
the kernel's declared size parameters (``Nest.param``) stay symbolic.  The
whole report is fitted/proved ONCE; ``.evaluate(N=..., T=...)`` then
instantiates it for any concrete size in microseconds, byte-identical (modulo
the diagnostics-only ``cache`` field) to a from-scratch concrete analysis.

Two cooperating layers, with a deliberate division of responsibility:

**Template layer (where evaluated output comes from).**  The concrete
pipeline is probed on a small *tensor grid* of sizes restricted to the
kernel's stride lattice (``base + stride·j`` per parameter; strides come from
the tiling hyperplanes, so quasi-polynomial Ehrhart behaviour collapses to a
single polynomial branch).  Everything non-numeric in the probed reports —
channel names, verdicts, split decisions, lowerings — must be *identical*
across probes (else the grid is shifted up one stride and retried, and after
that the engine falls back **loudly** to concrete analysis).  Every numeric
leaf (edge counts, raw pre-pow2 capacities captured by the size/plan stages)
is fitted as an exact multivariate polynomial (`SizePoly`, Fraction Gaussian
elimination on the tensor-grid Vandermonde); pow2-rounded leaves are
recomputed from the fitted raw capacities at evaluate time.  Per-axis holdout
probes beyond the fit grid must reproduce the instantiated report exactly.

**Proof layer (certainty annotations only).**  For each original channel the
dependence relation is fitted as an affine map ``src = M·dst + A·params + b``
(verified against the probed edge lists and an exact per-probe cardinality
check), turned into a symbolic `Relation`, and the classifier's violation
systems (`patterns.violation_systems`) are projected onto the size parameters
with parametric Fourier–Motzkin (`Polyhedron.project_onto`).  A *true* flag
(in-order / unicity holds) is **proved** when every violation system is
rationally empty for all sizes above the probe threshold θ (sound: FM is
exact for rational feasibility and integer points are rational); a *false*
flag is proved by a violating edge pair extracted from the probes, fitted
affine in the parameters, and shown to satisfy its violation system for all
sizes ≥ θ.  Statuses: ``proved`` (all integer sizes ≥ θ), ``proved_ray``
(lattice sizes only), ``probed`` (verdict observed on the probe grid and
extrapolated — the loud, honest default whenever a proof does not close).
Proofs never feed the evaluated output: correctness of ``evaluate`` rests on
the template + holdouts + the concrete-parity test-suite, never on proof
soundness.
"""
from __future__ import annotations

import copy
import itertools
import json
import math
import time
import warnings
from fractions import Fraction
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from .affine import LinExpr, eq, ge, v
from .analysis import AnalysisReport, analyze
from .dataflow import Kernel, Statement, enumerate_domain
from .patterns import Pattern, ProcSpace, _lex_rank, _violation_setup
from .polyhedron import FMBlowup, Polyhedron, polyhedron_cache_pin
from .schedule import AffineSchedule, lex_lt_at_depth
from .sizing import pow2_size
from .tiling import Tiling

__all__ = ["symbolic", "SizePoly", "ParametricAnalysis",
           "ParametricFallbackWarning"]


class _Symbolic:
    """Singleton sentinel: ``analyze(kernel, sizes=symbolic)``."""

    _instance: Optional["_Symbolic"] = None

    def __new__(cls) -> "_Symbolic":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "symbolic"


#: pass as ``analyze(kernel, sizes=symbolic)`` to get a `ParametricAnalysis`
symbolic = _Symbolic()


class ParametricFallbackWarning(UserWarning):
    """The symbolic engine fell back to concrete analysis (loudly)."""


#: per-flag proof statuses, strongest first
PROVED, PROVED_RAY, PROBED = "proved", "proved_ray", "probed"


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b) if a and b else max(a, b)


# ===================================================== exact linear algebra

def _rref_solve(rows: List[List[Fraction]], rhs: List[Fraction]
                ) -> Optional[List[Fraction]]:
    """Solve an (over)determined linear system exactly.  Returns a solution
    with free unknowns at 0, or None when the system is inconsistent."""
    m, n = len(rows), len(rows[0]) if rows else 0
    aug = [list(r) + [rhs[i]] for i, r in enumerate(rows)]
    pivots: List[Tuple[int, int]] = []
    r = 0
    for c in range(n):
        piv = next((i for i in range(r, m) if aug[i][c] != 0), None)
        if piv is None:
            continue
        aug[r], aug[piv] = aug[piv], aug[r]
        inv = Fraction(1) / aug[r][c]
        aug[r] = [x * inv for x in aug[r]]
        for i in range(m):
            if i != r and aug[i][c] != 0:
                f = aug[i][c]
                aug[i] = [x - f * y for x, y in zip(aug[i], aug[r])]
        pivots.append((r, c))
        r += 1
        if r == m:
            break
    for i in range(r, m):
        if aug[i][n] != 0:
            return None                      # 0 == nonzero: inconsistent
    sol = [Fraction(0)] * n
    for pr, pc in pivots:
        sol[pc] = aug[pr][n]
    return sol


# ================================================================= SizePoly

class SizePoly:
    """Exact multivariate polynomial over named size parameters.

    Coefficients are `Fraction`s (closed forms like ``N·(N+1)/2`` need
    halves); evaluation at lattice sizes must come out integral —
    `eval_int` raises otherwise instead of rounding silently.
    """

    __slots__ = ("params", "terms")

    def __init__(self, params: Sequence[str],
                 terms: Mapping[Tuple[int, ...], Fraction]):
        self.params: Tuple[str, ...] = tuple(params)
        self.terms: Dict[Tuple[int, ...], Fraction] = {
            tuple(e): Fraction(c) for e, c in terms.items() if c != 0}

    # ------------------------------------------------------------- algebra --
    def eval(self, env: Mapping[str, int]) -> Fraction:
        total = Fraction(0)
        vals = [env[p] for p in self.params]
        for exps, c in self.terms.items():
            t = c
            for val, e in zip(vals, exps):
                if e:
                    t *= Fraction(val) ** e
            total += t
        return total

    def eval_int(self, env: Mapping[str, int]) -> int:
        val = self.eval(env)
        if val.denominator != 1:
            raise ValueError(
                f"closed form {self} is not integral at {dict(env)}: {val}")
        return int(val)

    def __call__(self, **env: int):
        """Exact value at a size point: an int when integral, else the
        `Fraction` (between lattice points halves can appear)."""
        val = self.eval(env)
        return int(val) if val.denominator == 1 else val

    def __add__(self, other: "SizePoly") -> "SizePoly":
        assert self.params == other.params
        out = dict(self.terms)
        for e, c in other.terms.items():
            out[e] = out.get(e, Fraction(0)) + c
        return SizePoly(self.params, out)

    def degree(self) -> int:
        return max((sum(e) for e in self.terms), default=0)

    # ------------------------------------------------------------ printing --
    def _ordered(self) -> List[Tuple[Tuple[int, ...], Fraction]]:
        return sorted(self.terms.items(),
                      key=lambda t: (-sum(t[0]), tuple(-e for e in t[0])))

    def _term_str(self, exps: Tuple[int, ...], c: Fraction,
                  lead: bool = False) -> str:
        mono = "*".join(
            p if e == 1 else f"{p}**{e}"
            for p, e in zip(self.params, exps) if e)
        mag = abs(c)
        if not mono:
            body = str(mag)
        elif mag == 1:
            body = mono
        else:
            body = f"{mag}*{mono}"
        if lead:
            return body if c >= 0 else f"-{body}"
        return f"+ {body}" if c >= 0 else f"- {body}"

    def lead_term(self) -> str:
        """The highest-total-degree term — the asymptotic capacity law."""
        ordered = self._ordered()
        if not ordered:
            return "0"
        return self._term_str(*ordered[0], lead=True)

    def __str__(self) -> str:
        ordered = self._ordered()
        if not ordered:
            return "0"
        parts = [self._term_str(*ordered[0], lead=True)]
        parts += [self._term_str(e, c) for e, c in ordered[1:]]
        return " ".join(parts)

    def __repr__(self) -> str:
        return f"SizePoly({self})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, SizePoly):
            return NotImplemented
        return self.params == other.params and self.terms == other.terms

    # ---------------------------------------------------------------- JSON --
    def as_dict(self) -> Dict[str, Any]:
        return {"params": list(self.params),
                "terms": [[list(e), str(c)] for e, c in self._ordered()]}

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "SizePoly":
        return cls(tuple(doc["params"]),
                   {tuple(e): Fraction(c) for e, c in doc["terms"]})


class _GridFitter:
    """Interpolate values sampled on a full tensor grid of parameter values
    as a `SizePoly` with per-parameter degree bounds.  The Vandermonde
    inverse is computed once (exact, Fractions) and reused for every numeric
    leaf of the template."""

    def __init__(self, params: Sequence[str], degrees: Mapping[str, int],
                 pvecs: Sequence[Tuple[int, ...]]):
        self.params = tuple(params)
        self.exps = [tuple(e) for e in itertools.product(
            *[range(degrees[p] + 1) for p in self.params])]
        assert len(pvecs) == len(self.exps), "fit needs the full tensor grid"
        self.pvecs = [tuple(pv) for pv in pvecs]
        n = len(self.exps)
        a = [[Fraction(1) for _ in range(n)] for _ in range(n)]
        for i, pv in enumerate(self.pvecs):
            for j, exps in enumerate(self.exps):
                t = Fraction(1)
                for val, e in zip(pv, exps):
                    if e:
                        t *= Fraction(val) ** e
                a[i][j] = t
        self.inv = self._invert(a)

    @staticmethod
    def _invert(a: List[List[Fraction]]) -> List[List[Fraction]]:
        n = len(a)
        aug = [list(row) + [Fraction(int(i == j)) for j in range(n)]
               for i, row in enumerate(a)]
        for c in range(n):
            piv = next(i for i in range(c, n) if aug[i][c] != 0)
            aug[c], aug[piv] = aug[piv], aug[c]
            inv = Fraction(1) / aug[c][c]
            aug[c] = [x * inv for x in aug[c]]
            for i in range(n):
                if i != c and aug[i][c] != 0:
                    f = aug[i][c]
                    aug[i] = [x - f * y for x, y in zip(aug[i], aug[c])]
        return [row[n:] for row in aug]

    def fit(self, values: Sequence[int]) -> SizePoly:
        coeffs = [sum(r * Fraction(val) for r, val in zip(row, values))
                  for row in self.inv]
        return SizePoly(self.params,
                        dict(zip(self.exps, coeffs)))


# =============================================== probe lattice and degrees

def _degree_bounds(kernel: Kernel, params: Sequence[str]) -> Dict[str, int]:
    """Per-parameter degree bound for every count/capacity in the report:
    each statement contributes at most one polynomial factor per dimension
    whose extent can grow with the parameter.  A dimension counts if its
    constraints mention the parameter directly OR (transitively) another
    counted dimension — in triangular nests like trmm's ``k < i < N`` the
    inner dimension's extent is parameter-dependent through the middle one."""
    deg: Dict[str, int] = {}
    for p in params:
        best = 1
        for s in kernel.statements:
            touched = set()
            grown = True
            while grown:
                grown = False
                for c in s.domain:
                    names = set(c.expr.vars())
                    if p in names or names & touched:
                        new = {n for n in names if n in s.dims}
                        if not new <= touched:
                            touched |= new
                            grown = True
            best = max(best, len(touched))
        deg[p] = best
    return deg


def _strides(kernel: Kernel, tilings: Mapping[str, Tiling],
             params: Sequence[str]) -> Dict[str, int]:
    """Lattice stride per parameter: the period after which tile-boundary
    structure repeats.  A hyperplane ``⌊τ·i/b⌋`` over a dimension bounded by
    ``p`` with coefficient ``c`` repeats with period ``b / gcd(b, |c|)``;
    the stride is the lcm over every such hyperplane."""
    stride = {p: 1 for p in params}
    for s in kernel.statements:
        t = tilings.get(s.name)
        if t is None:
            continue
        for p in params:
            pdims = set()
            for c in s.domain:
                names = c.expr.vars()
                if p in names:
                    pdims.update(n for n in names if n in s.dims)
            for tau, b in zip(t.normals, t.sizes):
                for d, coeff in zip(s.dims, tau):
                    if coeff and d in pdims:
                        stride[p] = _lcm(stride[p],
                                         b // math.gcd(b, abs(coeff)))
    return stride


# ===================================================== template structure

def _structure_key(doc: Mapping[str, Any]) -> str:
    """A probed report with every size-dependent numeric leaf blanked — the
    part that must be literally identical across all probe sizes."""
    d = copy.deepcopy(dict(doc))
    d["params"] = None
    for ch in d.get("channels", ()):
        ch["edges"] = None
        ch.pop("slots", None)
    d["total_slots"] = None
    if d.get("plans"):
        for pl in d["plans"]:
            pl["buffer_slots"] = None
            pl["parts"] = [[p[0], p[1], None] for p in pl["parts"]]
    return json.dumps(d, sort_keys=True)


# ========================================================== the proof layer

def _sample_rows(pts: np.ndarray, cap: int = 4096) -> np.ndarray:
    """Deterministic subsample of an edge list (exactness is re-established
    by the per-probe cardinality check, which is never sampled)."""
    n = pts.shape[0]
    if n <= cap:
        return pts
    idx = np.unique(np.linspace(0, n - 1, cap).astype(np.int64))
    return pts[idx]


def _fit_edge_map(samples: List[Tuple[Tuple[int, ...], np.ndarray, np.ndarray]]
                  ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Fit ``src = M·dst + A·params + b`` with integer coefficients from
    sampled edges across all probes; verified exactly on every sample."""
    dsts = [d for _, _, d in samples]
    srcs = [s for _, s, _ in samples]
    if not dsts or dsts[0].shape[1] == 0 or srcs[0].shape[1] == 0:
        return None
    dp, dc = srcs[0].shape[1], dsts[0].shape[1]
    np_ = len(samples[0][0])
    x = np.concatenate([
        np.concatenate([d.astype(np.float64),
                        np.tile(np.array(pv, dtype=np.float64), (len(d), 1)),
                        np.ones((len(d), 1))], axis=1)
        for (pv, _, d) in samples])
    y = np.concatenate([s.astype(np.float64) for s in srcs])
    sol, *_ = np.linalg.lstsq(x, y, rcond=None)
    w = np.rint(sol).astype(np.int64)           # (dc+np+1) × dp
    m, a, b = w[:dc].T, w[dc:dc + np_].T, w[-1]
    for pv, s, d in samples:
        pred = d @ m.T + np.array(pv, dtype=np.int64) @ a.T + b
        if not np.array_equal(pred, s):
            return None
    return m, a, b


def _domain_matrix(stmt: Statement, params: Mapping[str, int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(M, c) with ``pts @ M.T + c >= 0`` ⟺ point in the statement domain."""
    poly = Polyhedron(c.substitute({p: LinExpr.const_expr(int(val))
                                    for p, val in params.items()})
                      for c in stmt.domain)
    m = np.zeros((len(poly.rows), len(stmt.dims)), dtype=np.int64)
    c = np.zeros(len(poly.rows), dtype=np.int64)
    for r, e in enumerate(poly.rows):
        c[r] = e.const
        for name, coeff in e.coeffs.items():
            m[r, stmt.dims.index(name)] = coeff
    return m, c


def _first_diff_depth(a: np.ndarray, b: np.ndarray) -> int:
    """1-based lex depth at which two timestamp vectors first differ."""
    diff = np.flatnonzero(a != b)
    return int(diff[0]) + 1 if diff.size else 0


def _edge_witness(kind: str, ppn, c) -> Optional[Dict[str, Any]]:
    """Canonical violating edge pair from a probe's concrete edge lists.

    in-order: the first adjacent descent of producer ranks in consumer order
    — a pair x→x', y→y' with x' ≺C y' and y ≺P x.
    unicity : the first duplicated source in producer order — x→x', y→y'
    with x = y and x' ≺C y'.
    Returns the two edges plus the (k1, k2) lex depths selecting the
    violation system the pair satisfies."""
    prod = ppn.processes[c.producer]
    cons = ppn.processes[c.consumer]
    src_ts = prod.local_ts(c.src_pts, ppn.params)
    dst_ts = cons.local_ts(c.dst_pts, ppn.params)
    src_rank = _lex_rank(src_ts)
    dst_rank = _lex_rank(dst_ts)
    order = np.argsort(dst_rank, kind="stable")
    if kind == "in-order":
        seq = src_rank[order]
        desc = np.flatnonzero(seq[1:] < seq[:-1])
        if desc.size == 0:
            return None
        e1, e2 = int(order[desc[0]]), int(order[desc[0] + 1])
        k2 = _first_diff_depth(src_ts[e2], src_ts[e1])   # y ≺P x
    else:
        perm = np.lexsort((dst_rank, src_rank))
        sr = src_rank[perm]
        dup = np.flatnonzero(sr[1:] == sr[:-1])
        if dup.size == 0:
            return None
        e1, e2 = int(perm[dup[0]]), int(perm[dup[0] + 1])
        k2 = None
    if dst_rank[e1] == dst_rank[e2]:
        return None                                      # need x' ≺C y' strict
    k1 = _first_diff_depth(dst_ts[e1], dst_ts[e2])       # x' ≺C y'
    return {"k1": k1, "k2": k2,
            "x": c.src_pts[e1].tolist(), "xp": c.dst_pts[e1].tolist(),
            "y": c.src_pts[e2].tolist(), "yp": c.dst_pts[e2].tolist()}


def _witness_env(wit: Mapping[str, Any], in_vars: Sequence[str],
                 out_vars: Sequence[str], prod_t: Optional[Tiling],
                 cons_t: Optional[Tiling]) -> Dict[str, int]:
    """Assignment of every violation-system variable for one edge pair:
    the four renamed coordinate blocks plus the φ tile coordinates
    introduced by `ProcSpace.timestamps` (prefixes ta_/tb_/tc_/td_, the
    order `_violation_setup` uses)."""
    env: Dict[str, int] = {}
    roles = (("a_", "ta_", in_vars, prod_t, wit["x"]),
             ("b_", "tb_", out_vars, cons_t, wit["xp"]),
             ("c_", "tc_", in_vars, prod_t, wit["y"]),
             ("d_", "td_", out_vars, cons_t, wit["yp"]))
    for prefix, uid, names, tiling, pt in roles:
        for name, val in zip(names, pt):
            env[f"{prefix}{name}"] = int(val)
        if tiling is not None:
            phis = tiling.tile_coords_of(
                np.array([pt], dtype=np.int64))[0]
            for k, phi in enumerate(phis):
                env[f"{uid}phi{k}"] = int(phi)
    return env


def _indexed_systems(rel, prod: ProcSpace, cons_: ProcSpace,
                     assumptions, kind: str
                     ) -> List[Tuple[int, Optional[int], Polyhedron]]:
    """`patterns.violation_systems` with its (k1, k2) depth indices exposed,
    so a witness can be checked against the exact system it violates."""
    (assumptions, p1, p2, a_vars, c_vars,
     ts_a, ts_b, ts_c, ts_d, aux) = _violation_setup(rel, prod, cons_,
                                                     assumptions)
    uniq = [eq(LinExpr.var(u), LinExpr.var(w))
            for u, w in zip(a_vars, c_vars)]
    out: List[Tuple[int, Optional[int], Polyhedron]] = []
    for poly1 in p1:
        for poly2 in p2:
            base = poly1.intersect(poly2).intersect(assumptions).intersect(aux)
            for k1 in range(1, len(ts_b) + 1):
                lhs = base.intersect(lex_lt_at_depth(ts_b, ts_d, k1))
                if kind == "in-order":
                    for k2 in range(1, len(ts_a) + 1):
                        out.append((k1, k2, lhs.intersect(
                            lex_lt_at_depth(ts_c, ts_a, k2))))
                else:
                    out.append((k1, None, lhs.intersect(uniq)))
    return out


def _ray_empty(q: Polyhedron, param: str, theta: int, stride: int) -> bool:
    """Is the projected system empty on the 1-D lattice ray
    ``p = θ + stride·u, u ≥ 0``?  (Integer-exact in one variable: each row
    ``c·p + d ≥ 0`` becomes ``c·s·u + (c·θ + d) ≥ 0`` and the bounds are
    tightened with exact ceil/floor before intersecting.)"""
    lo, hi = 0, None
    for row in q.rows:
        c = row.coeffs.get(param, 0)
        d = row.const + c * theta
        cs = c * stride
        if cs == 0:
            if d < 0:
                return True                  # constant row already violated
        elif cs > 0:
            lo = max(lo, -(d // cs))         # u ≥ ceil(-d/cs) = -floor(d/cs)
        else:
            hi_row = d // (-cs)              # u ≤ floor(d/|cs|)
            hi = hi_row if hi is None else min(hi, hi_row)
    return hi is not None and lo > hi


def _affine_of_params(pvecs: Sequence[Tuple[int, ...]],
                      vals: Sequence[int], nparams: int
                      ) -> Optional[Tuple[List[Fraction], Fraction]]:
    """Exact affine fit ``val = Σ cᵢ·pᵢ + c0`` over probe parameter vectors,
    consistent with every probe or None."""
    rows = [[Fraction(x) for x in pv] + [Fraction(1)] for pv in pvecs]
    sol = _rref_solve(rows, [Fraction(val) for val in vals])
    if sol is None:
        return None
    return sol[:nparams], sol[nparams]


class _WitnessExpr:
    """Affine-in-params value of one violation-system variable."""

    __slots__ = ("coeffs", "const")

    def __init__(self, coeffs: Sequence[Fraction], const: Fraction):
        self.coeffs = list(coeffs)
        self.const = const

    def integral_on(self, strides: Sequence[int], theta: Sequence[int]
                    ) -> Tuple[bool, bool]:
        """(integer everywhere, integer on the probe lattice)."""
        everywhere = all(c.denominator == 1 for c in self.coeffs) \
            and self.const.denominator == 1
        at_theta = (self.const
                    + sum(c * t for c, t in zip(self.coeffs, theta)))
        lattice = at_theta.denominator == 1 and all(
            (c * s).denominator == 1
            for c, s in zip(self.coeffs, strides))
        return everywhere, everywhere or lattice


class _ChannelProver:
    """Streams per-probe evidence for ONE original channel and, after the
    probe loop, attempts the symbolic proofs."""

    def __init__(self, producer: str, consumer: str, nparams: int):
        self.producer, self.consumer = producer, consumer
        self.nparams = nparams
        self.flags: Optional[Tuple[bool, bool]] = None
        self.samples: List[Tuple[Tuple[int, ...], np.ndarray, np.ndarray]] = []
        self.counts: List[Tuple[Tuple[int, ...], Dict[str, int], int]] = []
        self.witnesses: Dict[str, List[Optional[Dict[str, Any]]]] = {
            "in-order": [], "unicity": []}
        self.broken = False

    def observe(self, pvec: Tuple[int, ...], full_params: Dict[str, int],
                ppn, c, clf) -> None:
        flags = clf.edge_flags(c)
        if self.flags is None:
            self.flags = flags
        elif self.flags != flags:
            self.broken = True               # structure drift; template will
            return                           # have bailed already anyway
        self.samples.append((pvec, _sample_rows(c.src_pts),
                             _sample_rows(c.dst_pts)))
        self.counts.append((pvec, dict(full_params), c.num_edges))
        in_order, unicity = flags
        for kind, flag in (("in-order", in_order), ("unicity", unicity)):
            if not flag:
                self.witnesses[kind].append(_edge_witness(kind, ppn, c))

    # ---------------------------------------------------------- the proofs --
    def prove(self, kernel: Kernel, tilings: Mapping[str, Tiling],
              params: Tuple[str, ...], theta: Dict[str, int],
              strides: Dict[str, int], deadline: float
              ) -> Dict[str, Dict[str, Any]]:
        in_order, unicity = self.flags if self.flags is not None else (True,
                                                                       True)
        out = {
            "in-order": {"value": bool(in_order), "status": PROBED},
            "unicity": {"value": bool(unicity), "status": PROBED},
        }
        if self.broken:
            return out
        try:
            prod_stmt = kernel.statement(self.producer)
            cons_stmt = kernel.statement(self.consumer)
        except KeyError:
            return out
        if not prod_stmt.dims or not cons_stmt.dims:
            return out
        fit = _fit_edge_map(self.samples)
        if fit is None:
            return out
        m, a, b = fit
        for pvec, full, num_edges in self.counts:
            cons_pts = enumerate_domain(cons_stmt, full)
            mapped = (cons_pts @ m.T
                      + np.array(pvec, dtype=np.int64) @ a.T + b)
            dm, dc = _domain_matrix(prod_stmt, full)
            inside = ((mapped @ dm.T + dc) >= 0).all(axis=1) \
                if dm.shape[0] else np.ones(len(mapped), dtype=bool)
            if int(inside.sum()) != num_edges:
                return out                   # affine graph ≠ true relation
        rel, prod_sp, cons_sp = self._symbolic_relation(
            prod_stmt, cons_stmt, tilings, m, a, b, params)
        assumptions = [ge(v(p), 1) for p in params]
        pvecs = [pv for pv, _, _ in self.counts]
        for kind, flag in (("in-order", in_order), ("unicity", unicity)):
            if time.monotonic() > deadline:
                break
            try:
                systems = _indexed_systems(rel, prod_sp, cons_sp,
                                           assumptions, kind)
                if len(systems) > 128:
                    continue
                if flag:
                    status = self._prove_true(systems, params, theta,
                                              strides, deadline)
                else:
                    status = self._prove_false(
                        kind, systems, rel, tilings, params, pvecs,
                        theta, strides)
            except (FMBlowup, OverflowError):
                status = None
            if status is not None:
                out[kind]["status"] = status
                out[kind]["threshold"] = dict(theta)
        return out

    def _symbolic_relation(self, prod_stmt: Statement, cons_stmt: Statement,
                           tilings: Mapping[str, Tiling],
                           m: np.ndarray, a: np.ndarray, b: np.ndarray,
                           params: Tuple[str, ...]):
        from .relation import Relation
        in_vars = tuple(f"w{i}" for i in range(len(prod_stmt.dims)))
        out_vars = tuple(f"r{i}" for i in range(len(cons_stmt.dims)))
        piece = Polyhedron()
        for i, wv in enumerate(in_vars):
            rhs = LinExpr.const_expr(int(b[i]))
            for j, rv in enumerate(out_vars):
                if m[i, j]:
                    rhs = rhs + LinExpr.var(rv, int(m[i, j]))
            for k, p in enumerate(params):
                if a[i, k]:
                    rhs = rhs + LinExpr.var(p, int(a[i, k]))
            piece.add(eq(LinExpr.var(wv), rhs))
        wmap = dict(zip(prod_stmt.dims, in_vars))
        rmap = dict(zip(cons_stmt.dims, out_vars))
        for c in prod_stmt.domain:
            piece.add(c.rename(wmap))
        for c in cons_stmt.domain:
            piece.add(c.rename(rmap))
        rel = Relation(in_vars, out_vars, [piece], tuple(params))
        prod_sp = ProcSpace(in_vars, AffineSchedule(
            in_vars, [LinExpr.var(n) for n in in_vars]),
            tilings.get(prod_stmt.name))
        cons_sp = ProcSpace(out_vars, AffineSchedule(
            out_vars, [LinExpr.var(n) for n in out_vars]),
            tilings.get(cons_stmt.name))
        self._spaces = (in_vars, out_vars, prod_sp.tiling, cons_sp.tiling)
        return rel, prod_sp, cons_sp

    def _prove_true(self, systems, params: Tuple[str, ...],
                    theta: Dict[str, int], strides: Dict[str, int],
                    deadline: float) -> Optional[str]:
        """All violation systems empty beyond θ ⇒ the flag holds there."""
        level = PROVED
        for _, _, sys_poly in systems:
            if time.monotonic() > deadline:
                return None
            q = sys_poly.project_onto(params)
            if q is None:
                continue                     # empty for every size
            box = Polyhedron()
            box.rows = list(q.rows)
            for p in params:
                box.add(ge(v(p), theta[p]))
            if box.is_rationally_empty():
                continue                     # empty for every size ≥ θ
            if len(params) == 1 and _ray_empty(q, params[0],
                                              theta[params[0]],
                                              strides[params[0]]):
                level = PROVED_RAY           # empty on the probe lattice
                continue
            return None
        return level

    def _prove_false(self, kind: str, systems, rel,
                     tilings: Mapping[str, Tiling],
                     params: Tuple[str, ...],
                     pvecs: Sequence[Tuple[int, ...]],
                     theta: Dict[str, int], strides: Dict[str, int]
                     ) -> Optional[str]:
        """A violating edge pair, affine in the sizes, that stays inside its
        violation system for every size ≥ θ ⇒ the flag fails there."""
        wits = self.witnesses[kind]
        if len(wits) != len(pvecs) or any(w is None for w in wits):
            return None
        key = (wits[0]["k1"], wits[0]["k2"])
        if any((w["k1"], w["k2"]) != key for w in wits):
            return None                      # no single system covers all
        system = next((s for k1, k2, s in systems if (k1, k2) == key), None)
        if system is None:
            return None
        in_vars, out_vars, prod_t, cons_t = self._spaces
        envs = [_witness_env(w, in_vars, out_vars, prod_t, cons_t)
                for w in wits]
        names = sorted(envs[0])
        if any(sorted(e) != names for e in envs):
            return None
        nparams = len(params)
        exprs: Dict[str, _WitnessExpr] = {}
        for name in names:
            fitted = _affine_of_params(pvecs, [e[name] for e in envs],
                                       nparams)
            if fitted is None:
                return None
            exprs[name] = _WitnessExpr(*fitted)
        theta_vec = [theta[p] for p in params]
        stride_vec = [strides[p] for p in params]
        everywhere = all(
            exprs[name].integral_on(stride_vec, theta_vec)[0]
            for name in names)
        lattice = all(
            exprs[name].integral_on(stride_vec, theta_vec)[1]
            for name in names)
        if not lattice:
            return None
        # substitute the affine witness into every system row and require
        # it to stay ≥ 0 for all sizes ≥ θ: param coefficients ≥ 0 and the
        # value at θ ≥ 0 (monotone box argument)
        for row in system.rows:
            coeffs = [Fraction(row.coeffs.get(p, 0)) for p in params]
            const = Fraction(row.const)
            known = True
            for name, c in row.coeffs.items():
                if name in params:
                    continue
                w = exprs.get(name)
                if w is None:
                    known = False
                    break
                const += c * w.const
                coeffs = [cc + c * wc for cc, wc in zip(coeffs, w.coeffs)]
            if not known:
                return None
            at_theta = const + sum(c * t for c, t in zip(coeffs, theta_vec))
            if at_theta < 0 or any(c < 0 for c in coeffs):
                return None
        return PROVED if everywhere else PROVED_RAY


# ====================================================== the staged driver

def _run_stage_plan(base, stage_plan):
    a = base
    for name, kw in stage_plan:
        a = getattr(a, name)(**kw)
    return a


class ParametricAnalysis:
    """The symbolic-size pipeline: same staged surface as `Analysis`, one
    probe-and-prove pass, then `evaluate(N=..., T=...)` in microseconds.

        pa = (analyze(case, sizes=symbolic)
              .classify().fifoize().size(pow2=True).plan())
        rep16 = pa.evaluate(N=16)      # byte-identical to concrete analysis
        rep64 = pa.evaluate(N=64)      # same template, no re-analysis

    Stage methods only record the pipeline to run — the template is built
    lazily on the first `evaluate`/`report`/`prepare` and cached on this
    instance.  While the instance is alive its polyhedron-cache entries are
    pinned against half-eviction (`polyhedron_cache_pin`), so symbolic
    re-evaluation never has to refill the memo mid-flight."""

    def __init__(self, kernel: Kernel, tilings: Mapping[str, Tiling],
                 overrides: Mapping[str, int],
                 stage_plan: Sequence[Tuple[str, Dict[str, Any]]] = (),
                 prove: bool = True, prove_budget: float = 8.0,
                 probe_attempts: int = 4):
        self.kernel = kernel
        self.tilings = dict(tilings)
        self.overrides = dict(overrides)
        self.stage_plan: Tuple[Tuple[str, Dict[str, Any]], ...] = tuple(
            (n, dict(kw)) for n, kw in stage_plan)
        self.prove = prove
        self.prove_budget = float(prove_budget)
        self.probe_attempts = int(probe_attempts)
        self._template: Optional[Dict[str, Any]] = None
        self._pin = None

    # ------------------------------------------------------------ creation --
    @staticmethod
    def start(kernel: Any, params: Optional[Mapping[str, int]] = None,
              tilings: Optional[Mapping[str, Tiling]] = None,
              prove: bool = True, prove_budget: float = 8.0
              ) -> "ParametricAnalysis":
        """Entry point used by ``analyze(kernel, sizes=symbolic)``; accepts
        everything `analyze` does except a prebuilt `PPN` (that is already
        enumerated at one fixed size).  ``params`` pins individual parameters
        to concrete values; the rest stay symbolic."""
        from .ppn import PPN
        if hasattr(kernel, "__kernelcase__"):
            kernel = kernel.__kernelcase__()
        if isinstance(kernel, PPN):
            raise TypeError("parametric analysis needs the Kernel — a PPN "
                            "is already enumerated at a fixed size")
        if hasattr(kernel, "kernel") and hasattr(kernel, "tilings"):
            case = kernel
            kernel = case.kernel
            tilings = dict(case.tilings, **(tilings or {}))
        overrides = {p: int(val) for p, val in (params or {}).items()}
        sym = tuple(p for p in kernel.params if p not in overrides)
        if not sym:
            raise ValueError(
                f"kernel {kernel.name!r} declares no symbolic size "
                f"parameters (declare sizes with Nest.param, or drop the "
                f"params= overrides pinning them all)")
        return ParametricAnalysis(kernel, dict(tilings or {}), overrides,
                                  prove=prove, prove_budget=prove_budget)

    @property
    def symbolic_params(self) -> Tuple[str, ...]:
        return tuple(p for p in self.kernel.params
                     if p not in self.overrides)

    @property
    def stages(self) -> Tuple[str, ...]:
        return ("ppn",) + tuple(n for n, _ in self.stage_plan)

    @property
    def status(self) -> Optional[str]:
        """None before the template is built, else 'symbolic'/'fallback'."""
        return None if self._template is None else self._template["status"]

    # -------------------------------------------------------------- stages --
    def _with(self, stage_plan) -> "ParametricAnalysis":
        return ParametricAnalysis(self.kernel, self.tilings, self.overrides,
                                  stage_plan, prove=self.prove,
                                  prove_budget=self.prove_budget,
                                  probe_attempts=self.probe_attempts)

    def classify(self) -> "ParametricAnalysis":
        return self._with(self.stage_plan + (("classify", {}),))

    def fifoize(self) -> "ParametricAnalysis":
        return self._with(self.stage_plan + (("fifoize", {}),))

    def size(self, pow2: bool = True) -> "ParametricAnalysis":
        return self._with(self.stage_plan
                          + (("size", {"pow2": bool(pow2)}),))

    def plan(self, topology: str = "sequential") -> "ParametricAnalysis":
        if topology not in ("sequential", "pipeline"):
            raise ValueError(f"unknown topology {topology!r}")
        return self._with(self.stage_plan
                          + (("plan", {"topology": topology}),))

    def validate(self, *args, **kwargs) -> "ParametricAnalysis":
        raise ValueError(
            "validate is an operational replay and needs one concrete size; "
            "evaluate(...) first and validate that concrete analysis")

    # ------------------------------------------------------ template build --
    def prepare(self) -> "ParametricAnalysis":
        """Force the probe/fit/prove pass now (it is otherwise lazy)."""
        self._ensure_template()
        return self

    def release(self) -> None:
        """Drop the polyhedron-cache pin (entries become evictable again)."""
        if self._pin is not None:
            self._pin.release()

    def _ensure_template(self) -> Dict[str, Any]:
        if self._template is None:
            self._pin = polyhedron_cache_pin()
            with self._pin:
                self._template = self._build_template()
        return self._template

    def _fallback(self, reason: str) -> Dict[str, Any]:
        warnings.warn(
            f"{self.kernel.name}: parametric analysis falls back to "
            f"concrete runs — {reason}", ParametricFallbackWarning,
            stacklevel=3)
        return {"status": "fallback", "reason": reason}

    def _build_template(self) -> Dict[str, Any]:
        sym = self.symbolic_params
        degrees = _degree_bounds(self.kernel, sym)
        strides = _strides(self.kernel, self.tilings, sym)
        if math.prod(d + 1 for d in degrees.values()) > 64:
            return self._fallback(
                f"probe grid too large (degrees {degrees})")
        base = {}
        base_strides = strides
        # The per-hyperplane lcm is a *divisor* of the true Ehrhart
        # quasi-period; cross-hyperplane interaction (cholesky's triangular
        # tiles) can double it, so after every base shift fails on the
        # natural lattice, retry once on the doubled one (each residue class
        # of the coarser lattice is a single polynomial branch again).
        for scale in (1, 2):
            strides = {p: base_strides[p] * scale for p in sym}
            for attempt in range(self.probe_attempts):
                base = {p: int(self.kernel.params[p]) + attempt * strides[p]
                        for p in sym}
                t = self._attempt(base, degrees, strides)
                if t is not None:
                    return t
        return self._fallback(
            f"report structure or closed forms not stable on the probe "
            f"lattices up to base {base}")

    def _run_probe(self, env: Mapping[str, int]):
        pp = dict(self.overrides)
        pp.update(env)
        base_a = analyze(self.kernel, params=pp, tilings=self.tilings)
        base_a.ctx.capture = cap = {}
        final = _run_stage_plan(base_a, self.stage_plan)
        from .sweep import report_payload
        return report_payload(final.report()), cap, base_a

    def _attempt(self, base: Dict[str, int], degrees: Dict[str, int],
                 strides: Dict[str, int]) -> Optional[Dict[str, Any]]:
        sym = self.symbolic_params
        grid = sorted(
            itertools.product(*[[base[p] + strides[p] * j
                                 for j in range(degrees[p] + 1)]
                                for p in sym]),
            key=lambda pv: math.prod(pv))
        holdouts = []
        for p in sym:
            hv = tuple(base[q] if q != p
                       else base[p] + strides[p] * (degrees[p] + 1)
                       for q in sym)
            if hv not in grid and hv not in holdouts:
                holdouts.append(hv)
        probes: List[Tuple[Tuple[int, ...], Dict, Dict]] = []
        provers: Dict[str, _ChannelProver] = {}
        key0: Optional[str] = None
        for pv in list(grid) + holdouts:
            env = dict(zip(sym, pv))
            doc, cap, base_a = self._run_probe(env)
            skey = _structure_key(doc)
            if key0 is None:
                key0 = skey
            elif skey != key0:
                return None                      # shift the lattice, retry
            probes.append((pv, doc, cap))
            if self.prove:
                root = base_a.ppn
                clf = base_a.ctx.classifier(root)
                full = dict(root.params)
                for c in root.channels:
                    pr = provers.setdefault(c.name, _ChannelProver(
                        c.producer, c.consumer, len(sym)))
                    pr.observe(pv, full, root, c, clf)
        fitter = _GridFitter(sym, degrees, grid)
        grid_probes = probes[:len(grid)]
        by_grid_order = {pv: (doc, cap) for pv, doc, cap in grid_probes}
        docs = [by_grid_order[pv][0] for pv in fitter.pvecs]
        caps = [by_grid_order[pv][1] for pv in fitter.pvecs]
        doc0 = copy.deepcopy(probes[0][1])
        edges_poly = {
            row["name"]: fitter.fit(
                [d["channels"][i]["edges"] for d in docs])
            for i, row in enumerate(doc0["channels"])}
        size_poly = None
        if caps[0].get("size_raw") is not None:
            size_poly = {
                name: fitter.fit([c["size_raw"][name] for c in caps])
                for name in caps[0]["size_raw"]}
        plan_poly = None
        if caps[0].get("plan_raw") is not None:
            plan_poly = {
                name: [fitter.fit([c["plan_raw"][name][j][1] for c in caps])
                       for j in range(len(parts))]
                for name, parts in caps[0]["plan_raw"].items()}
        template: Dict[str, Any] = {
            "status": "symbolic",
            "doc0": doc0,
            "theta": dict(base), "strides": dict(strides),
            "degrees": dict(degrees),
            "edges": edges_poly, "size_raw": size_poly,
            "plan_raw": plan_poly,
            "sizes_pow2": doc0.get("sizes_pow2"),
            "probes": [dict(zip(sym, pv)) for pv, _, _ in probes],
        }
        # every probe — fit grid AND the per-axis extrapolation holdouts —
        # must be reproduced exactly by the instantiated template, at the
        # RAW (pre-pow2) level too: power-of-two rounding can hide a
        # diverging capacity fit behind an identical rounded slot count
        # (lu's upd->div.A[1] is 4 at N=12 then constant 5 — the cubic
        # through the θ=12 grid rounds to the right pow2 at the holdout
        # but not beyond; the θ=16 lattice fits it exactly)
        for pv, doc, cap in probes:
            env = dict(zip(sym, pv))
            full = dict(self.kernel.params)
            full.update(self.overrides)
            full.update(env)
            if self._instantiate(template, full, env) != doc:
                return None
            if size_poly is not None:
                for name, poly in size_poly.items():
                    if poly(**env) != cap["size_raw"][name]:
                        return None
            if plan_poly is not None:
                for name, polys in plan_poly.items():
                    parts = cap["plan_raw"][name]
                    for j, poly in enumerate(polys):
                        if poly(**env) != parts[j][1]:
                            return None
        if self.prove:
            deadline = time.monotonic() + self.prove_budget
            template["proofs"] = {
                name: pr.prove(self.kernel, self.tilings, sym, base,
                               strides, deadline)
                for name, pr in provers.items()}
        else:
            template["proofs"] = {}
        return template

    # ------------------------------------------------------- instantiation --
    @staticmethod
    def _instantiate(t: Mapping[str, Any], full_params: Mapping[str, int],
                     env: Mapping[str, int]) -> Dict[str, Any]:
        doc = copy.deepcopy(t["doc0"])
        doc["params"] = {p: int(val) for p, val in full_params.items()}
        total = 0
        for ch in doc["channels"]:
            name = ch["name"]
            ch["edges"] = t["edges"][name].eval_int(env)
            if "slots" in ch:
                raw = t["size_raw"][name].eval_int(env)
                ch["slots"] = pow2_size(raw) if t["sizes_pow2"] else raw
                total += ch["slots"]
        if t["size_raw"] is not None:
            doc["total_slots"] = total
        if doc.get("plans"):
            for pl in doc["plans"]:
                polys = t["plan_raw"][pl["name"]]
                parts, slots = [], 0
                for part, poly in zip(pl["parts"], polys):
                    s = pow2_size(poly.eval_int(env))
                    parts.append([part[0], part[1], s])
                    slots += s
                pl["parts"] = parts
                pl["buffer_slots"] = slots
        return doc

    def _in_region(self, env: Mapping[str, int], t: Mapping[str, Any]
                   ) -> bool:
        return all(
            env[p] >= t["theta"][p]
            and (env[p] - t["theta"][p]) % t["strides"][p] == 0
            for p in self.symbolic_params)

    def _concrete_report(self, env: Mapping[str, int]) -> AnalysisReport:
        pp = dict(self.overrides)
        pp.update(env)
        base_a = analyze(self.kernel, params=pp, tilings=self.tilings)
        return _run_stage_plan(base_a, self.stage_plan).report()

    # ------------------------------------------------------------ evaluate --
    def evaluate(self, **sizes: int) -> AnalysisReport:
        """The report at one concrete size — byte-identical (modulo the
        diagnostics-only ``cache`` field) to running the same stages
        concretely.  Sizes off the proved lattice region fall back, loudly,
        to a real concrete analysis."""
        t = self._ensure_template()
        sym = self.symbolic_params
        unknown = sorted(set(sizes) - set(sym))
        if unknown:
            raise ValueError(
                f"unknown size parameter(s) {unknown}; symbolic parameters "
                f"are {list(sym)}")
        env = {p: int(sizes.get(p, self.kernel.params[p])) for p in sym}
        if t["status"] != "symbolic":
            return self._concrete_report(env)
        if not self._in_region(env, t):
            warnings.warn(
                f"{self.kernel.name}: size {env} is outside the proved "
                f"lattice (θ={t['theta']}, stride={t['strides']}) — "
                f"running a concrete analysis instead",
                ParametricFallbackWarning, stacklevel=2)
            return self._concrete_report(env)
        full = dict(self.kernel.params)
        full.update(self.overrides)
        full.update(env)
        doc = self._instantiate(t, full, env)
        return AnalysisReport(
            kernel=doc["kernel"], params=doc["params"],
            stages=doc["stages"], channels=doc["channels"],
            fifoize=doc["fifoize"], sizes_pow2=doc["sizes_pow2"],
            total_slots=doc["total_slots"], plans=doc["plans"],
            validation=doc["validation"], selftimed=doc["selftimed"],
            resilience=doc["resilience"], parametric=None,
            cache={"evaluated": True},
            schema_version=doc["schema_version"])

    # -------------------------------------------------------------- report --
    def closed_forms(self) -> Dict[str, SizePoly]:
        """Per-channel raw (pre-pow2) capacity closed forms.  Requires the
        pipeline to include ``size`` and the template to have closed."""
        t = self._ensure_template()
        if t["status"] != "symbolic":
            raise ValueError(f"no closed forms: {t['reason']}")
        if t["size_raw"] is None:
            raise ValueError("no closed forms: the pipeline has no "
                             "size stage (call .size() first)")
        return dict(t["size_raw"])

    def _parametric_doc(self, t: Mapping[str, Any]) -> Dict[str, Any]:
        if t["status"] != "symbolic":
            return {"status": "fallback", "reason": t["reason"]}
        doc: Dict[str, Any] = {
            "status": "symbolic",
            "params": {p: {"threshold": t["theta"][p],
                           "stride": t["strides"][p],
                           "degree": t["degrees"][p]}
                       for p in self.symbolic_params},
            "probes": list(t["probes"]),
        }
        summary = {PROVED: 0, PROVED_RAY: 0, PROBED: 0}
        channels: Dict[str, Any] = {}
        for name, proofs in t["proofs"].items():
            io = proofs["in-order"]
            un = proofs["unicity"]
            channels[name] = {
                "pattern": Pattern.of(io["value"], un["value"]).value,
                "in_order": io, "unicity": un,
            }
            summary[io["status"]] += 1
            summary[un["status"]] += 1
        doc["channels"] = channels
        doc["proof_summary"] = summary
        if t["size_raw"] is not None:
            doc["sizes"] = {
                name: {"capacity": str(poly), "lead": poly.lead_term()}
                for name, poly in sorted(t["size_raw"].items())}
            total = None
            for poly in t["size_raw"].values():
                total = poly if total is None else total + poly
            if total is not None:
                doc["total_capacity"] = {"capacity": str(total),
                                         "lead": total.lead_term()}
            doc["sizes_pow2"] = t["sizes_pow2"]
        return doc

    def report(self) -> AnalysisReport:
        """The report at the kernel's default sizes with the ``parametric``
        section (schema v5) attached: per-parameter thresholds/strides,
        per-channel symbolic verdicts with proof statuses, and closed-form
        capacity expressions with extracted lead terms."""
        t = self._ensure_template()
        rep = self.evaluate()
        rep.parametric = self._parametric_doc(t)
        return rep
