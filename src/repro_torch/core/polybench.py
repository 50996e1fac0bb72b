"""PolyBench/C 3.2 kernels as polyhedral specs (paper §4 experimental setup).

Every kernel is authored with the declarative `repro_torch.lang` frontend
(`docs/frontend.md`): loop nests built with ``Nest.loop``/``Nest.stmt``,
affine accesses as operator-overloaded index expressions, 2d+1 schedules
assigned automatically from program order, and ``load_*``/``store_*``
boundary processes derived from the declared I/O (prologue ≪ body ≪
epilogue phase ordering owned by `core.schedule`).  Compilation to
`Kernel`/`KernelCase` produces byte-identical `AnalysisReport`s to the
original hand-assembled `Statement` tables — pinned against recorded
fixtures in ``tests/test_golden_parity.py``.

Each case also carries the loop tiling used for the experiment (rectangular
for linear algebra, skewed for stencils, exactly as valid tilings for each
kernel's dependences).  Statements living in a sub-band of the tiled nest
embed into the common tile space with degenerate normals (constant tile
coordinates) so FIFOIZE can compare tile depths across producer/consumer.

Structure parameters are *symbolic with concrete defaults*: every kernel
declares its sizes with ``Nest.param`` (``N = k.param("N", 12 * scale)``),
so the concrete pipeline behaves exactly as before (defaults baked into
``Kernel.params``; the enumeration backend is exact for fixed sizes, like
the paper's tool which sizes channels for fixed PolyBench sizes), while
``analyze(case, sizes=symbolic)`` analyses the same spec once for all
sizes.  The ``scale`` argument scales the defaults; ``analyze(...,
params={"N": n})`` overrides them per run.

The registry here is the frontend-agnostic `core.registry`; the old raw
authoring helpers (``sched``/``rng``/``load``/``store``) remain as
warn-once deprecated shims for external callers.
"""
from __future__ import annotations

from typing import List, Sequence

from .affine import Constraint, LinExpr, ge, le, lt, v
from .dataflow import Access, Kernel, Statement
from .deprecation import deprecated_shim
from .registry import KernelCase, get, kernel_names, register
from .schedule import (AffineSchedule, LEGACY_EPILOGUE_C0, PROLOGUE_C0,
                       boundary_schedule)
from .tiling import Tiling
from ..lang import Nest

__all__ = ["KernelCase", "Kernel", "get", "kernel_names", "register",
           "jacobi_1d_paper", "E", "rd", "wr", "sched", "rng", "load",
           "store"]


def E(x) -> LinExpr:
    return LinExpr.coerce(x)


def rd(arr: str, *idx) -> Access:
    return Access(arr, tuple(E(i) for i in idx))


wr = rd


# ------------------------------------------------- deprecated raw authoring
#
# The pre-`repro_torch.lang` spec format: hand-built schedules with hand-numbered
# scalar dims and copy-pasted boundary processes.  Kept as warn-once shims
# (behaviour unchanged) for external callers; nothing in this repository
# uses them anymore.

_LANG_MSG = ("{name}() is a legacy raw-spec authoring helper; author kernels "
             "with the declarative {replacement} frontend instead "
             "(docs/frontend.md)")


@deprecated_shim("repro_torch.lang.Nest", message=_LANG_MSG)
def sched(dims: Sequence[str], *exprs) -> AffineSchedule:
    return AffineSchedule(tuple(dims), [E(e) for e in exprs])


@deprecated_shim("repro_torch.lang.Nest", message=_LANG_MSG)
def rng(d: str, lo, hi_excl) -> List[Constraint]:
    return _rng(d, lo, hi_excl)


def _rng(d: str, lo, hi_excl) -> List[Constraint]:
    return [ge(v(d), E(lo)), lt(v(d), E(hi_excl))]


@deprecated_shim("repro_torch.lang.Nest", message=_LANG_MSG)
def load(arr: str, rank: int, *extents) -> Statement:
    """Input process: writes every cell of ``arr`` before the computation."""
    dims = tuple(f"l{k}" for k in range(len(extents)))
    dom: List[Constraint] = []
    for d, ext in zip(dims, extents):
        dom += _rng(d, 0, ext)
    return Statement(f"load_{arr}", dims, dom,
                     boundary_schedule(dims, PROLOGUE_C0, rank),
                     writes=[wr(arr, *[v(d) for d in dims])])


@deprecated_shim("repro_torch.lang.Nest", message=_LANG_MSG)
def store(arr: str, rank: int, *extents) -> Statement:
    dims = tuple(f"s{k}" for k in range(len(extents)))
    dom: List[Constraint] = []
    for d, ext in zip(dims, extents):
        dom += _rng(d, 0, ext)
    return Statement(f"store_{arr}", dims, dom,
                     boundary_schedule(dims, LEGACY_EPILOGUE_C0, rank),
                     reads=[rd(arr, *[v(d) for d in dims])])


def _rect(dims: Sequence[str], tiled: Sequence[str], b: int) -> Tiling:
    """Tiling of `dims` with one hyperplane per name in `tiled`; names not in
    `dims` become degenerate (constant-0) coordinates."""
    normals = []
    for t in tiled:
        normals.append(tuple(1 if d == t else 0 for d in dims))
    return Tiling(tuple(normals), tuple(b for _ in tiled))


# =========================================================== linear algebra

@register("gemm")
def gemm(scale: int = 1) -> Nest:
    k = Nest("gemm")
    N, b = k.param("N", 12 * scale), 4
    C, A, B = k.array("C", N, N), k.array("A", N, N), k.array("B", N, N)
    k.inputs(C, A, B)
    k.outputs(C)
    with k.loop("i", 0, N) as i, k.loop("j", 0, N) as j:
        k.stmt("init", writes=[C[i, j]], reads=[C[i, j]])
        with k.loop("k", 0, N) as kk:
            k.stmt("upd", writes=[C[i, j]],
                   reads=[C[i, j], A[i, kk], B[kk, j]])
    k.tile("init", _rect(("i", "j"), ("i", "j", "k"), b))
    k.tile("upd", _rect(("i", "j", "k"), ("i", "j", "k"), b))
    return k


@register("trmm")
def trmm(scale: int = 1) -> Nest:
    k = Nest("trmm")
    N, b = k.param("N", 12 * scale), 4
    A, B = k.array("A", N, N), k.array("B", N, N)
    k.inputs(A, B)
    k.outputs(B)
    with k.loop("i", 1, N) as i, k.loop("j", 0, N) as j:
        with k.loop("k", 0, i) as kk:
            k.stmt("upd", writes=[B[i, j]],
                   reads=[B[i, j], A[i, kk], B[kk, j]])
    k.tile("upd", _rect(("i", "j", "k"), ("i", "j", "k"), b))
    return k


@register("syrk")
def syrk(scale: int = 1) -> Nest:
    k = Nest("syrk")
    N, b = k.param("N", 12 * scale), 4
    C, A = k.array("C", N, N), k.array("A", N, N)
    k.inputs(C, A)
    k.outputs(C)
    with k.loop("i", 0, N) as i, k.loop("j", 0, N) as j:
        k.stmt("init", writes=[C[i, j]], reads=[C[i, j]])
        with k.loop("k", 0, N) as kk:
            k.stmt("upd", writes=[C[i, j]],
                   reads=[C[i, j], A[i, kk], A[j, kk]])
    k.tile("init", _rect(("i", "j"), ("i", "j", "k"), b))
    k.tile("upd", _rect(("i", "j", "k"), ("i", "j", "k"), b))
    return k


@register("syr2k")
def syr2k(scale: int = 1) -> Nest:
    k = Nest("syr2k")
    N, b = k.param("N", 12 * scale), 4
    C, A, B = k.array("C", N, N), k.array("A", N, N), k.array("B", N, N)
    k.inputs(C, A, B)
    k.outputs(C)
    with k.loop("i", 0, N) as i, k.loop("j", 0, N) as j:
        k.stmt("init", writes=[C[i, j]], reads=[C[i, j]])
        with k.loop("k", 0, N) as kk:
            k.stmt("upd", writes=[C[i, j]],
                   reads=[C[i, j], A[i, kk], B[j, kk], B[i, kk], A[j, kk]])
    k.tile("init", _rect(("i", "j"), ("i", "j", "k"), b))
    k.tile("upd", _rect(("i", "j", "k"), ("i", "j", "k"), b))
    return k


@register("symm")
def symm(scale: int = 1) -> Nest:
    k = Nest("symm")
    N, b = k.param("N", 12 * scale), 4
    C, A, B = k.array("C", N, N), k.array("A", N, N), k.array("B", N, N)
    acc = k.array("acc", N, N)
    k.inputs(C, A, B)
    k.outputs(C)
    with k.loop("i", 0, N) as i, k.loop("j", 0, N) as j:
        k.stmt("accinit", writes=[acc[i, j]])
        with k.loop("k", 0, i) as kk:
            k.stmt("cupd", writes=[C[kk, j]],
                   reads=[C[kk, j], A[kk, i], B[i, j]])
            k.stmt("accupd", writes=[acc[i, j]],
                   reads=[acc[i, j], B[kk, j], A[kk, i]])
        k.stmt("cfin", writes=[C[i, j]],
               reads=[C[i, j], A[i, i], B[i, j], acc[i, j]])
    k.tile("accinit", _rect(("i", "j"), ("i", "j", "k"), b))
    k.tile("cupd", _rect(("i", "j", "k"), ("i", "j", "k"), b))
    k.tile("accupd", _rect(("i", "j", "k"), ("i", "j", "k"), b))
    k.tile("cfin", _rect(("i", "j"), ("i", "j", "k"), b))
    return k


@register("gemver")
def gemver(scale: int = 1) -> Nest:
    k = Nest("gemver")
    N, b = k.param("N", 12 * scale), 4
    A = k.array("A", N, N)
    u1, v1, u2, v2 = (k.array(n, N) for n in ("u1", "v1", "u2", "v2"))
    x, y, z, w = (k.array(n, N) for n in ("x", "y", "z", "w"))
    k.inputs(A, u1, v1, u2, v2, x, y, z, w)
    k.outputs(x, w)
    with k.loop("i", 0, N) as i, k.loop("j", 0, N) as j:
        k.stmt("ahat", writes=[A[i, j]],
               reads=[A[i, j], u1[i], v1[j], u2[i], v2[j]])
    with k.loop("i", 0, N) as i, k.loop("j", 0, N) as j:
        k.stmt("xupd", writes=[x[i]], reads=[x[i], A[j, i], y[j]])
    with k.loop("i", 0, N) as i:
        k.stmt("xz", writes=[x[i]], reads=[x[i], z[i]])
    with k.loop("i", 0, N) as i, k.loop("j", 0, N) as j:
        k.stmt("wupd", writes=[w[i]], reads=[w[i], A[i, j], x[j]])
    k.tile("ahat", _rect(("i", "j"), ("i", "j"), b))
    k.tile("xupd", _rect(("i", "j"), ("i", "j"), b))
    k.tile("xz", _rect(("i",), ("i", "j"), b))
    k.tile("wupd", _rect(("i", "j"), ("i", "j"), b))
    return k


@register("gesummv")
def gesummv(scale: int = 1) -> Nest:
    k = Nest("gesummv")
    N, b = k.param("N", 12 * scale), 4
    A, B = k.array("A", N, N), k.array("B", N, N)
    x, y, tmp = k.array("x", N), k.array("y", N), k.array("tmp", N)
    k.inputs(A, B, x)
    k.outputs(y)
    with k.loop("i", 0, N) as i:
        k.stmt("tinit", writes=[tmp[i]])
        k.stmt("yinit", writes=[y[i]])
        with k.loop("j", 0, N) as j:
            k.stmt("tupd", writes=[tmp[i]], reads=[tmp[i], A[i, j], x[j]])
            k.stmt("yupd", writes=[y[i]], reads=[y[i], B[i, j], x[j]])
        k.stmt("yfin", writes=[y[i]], reads=[tmp[i], y[i]])
    k.tile("tinit", _rect(("i",), ("i", "j"), b))
    k.tile("yinit", _rect(("i",), ("i", "j"), b))
    k.tile("tupd", _rect(("i", "j"), ("i", "j"), b))
    k.tile("yupd", _rect(("i", "j"), ("i", "j"), b))
    k.tile("yfin", _rect(("i",), ("i", "j"), b))
    return k


@register("lu")
def lu(scale: int = 1) -> Nest:
    k = Nest("lu")
    N, b = k.param("N", 12 * scale), 4
    A = k.array("A", N, N)
    k.inputs(A)
    k.outputs(A)
    with k.loop("k", 0, N) as kk:
        with k.loop("j", kk + 1, N) as j:
            k.stmt("div", writes=[A[kk, j]], reads=[A[kk, j], A[kk, kk]])
        with k.loop("i", kk + 1, N) as i:
            with k.loop("j", kk + 1, N) as j:
                k.stmt("upd", writes=[A[i, j]],
                       reads=[A[i, j], A[i, kk], A[kk, j]])
    k.tile("div", Tiling(((1, 0), (0, 1)), (b, b)))
    k.tile("upd", Tiling(((1, 0, 0), (0, 0, 1)), (b, b)))
    return k


@register("cholesky")
def cholesky(scale: int = 1) -> Nest:
    k = Nest("cholesky")
    N, b = k.param("N", 12 * scale), 4
    A, L, y = k.array("A", N, N), k.array("L", N, N), k.array("y", N, N)
    x, p = k.array("x", N), k.array("p", N)
    k.inputs(A)
    k.outputs(L, p)
    with k.loop("i", 0, N) as i:
        k.stmt("xinit", writes=[x[i]], reads=[A[i, i]])
        with k.loop("j", 0, i) as j:
            k.stmt("xupd", writes=[x[i]], reads=[x[i], L[i, j]])
        k.stmt("pset", writes=[p[i]], reads=[x[i]])
        with k.loop("j", i + 1, N) as j:
            k.stmt("yinit", writes=[y[i, j]], reads=[A[i, j]])
            with k.loop("k", 0, i) as kk:
                k.stmt("yupd", writes=[y[i, j]],
                       reads=[y[i, j], L[j, kk], L[i, kk]])
            k.stmt("lset", writes=[L[j, i]], reads=[y[i, j], p[i]])
    k.tile("xinit", Tiling(((1,), (0,)), (b, b)))
    k.tile("xupd", Tiling(((1, 0), (0, 1)), (b, b)))
    k.tile("pset", Tiling(((1,), (0,)), (b, b)))
    k.tile("yinit", Tiling(((1, 0), (0, 1)), (b, b)))
    k.tile("yupd", Tiling(((1, 0, 0), (0, 1, 0)), (b, b)))
    k.tile("lset", Tiling(((1, 0), (0, 1)), (b, b)))
    return k


@register("atax")
def atax(scale: int = 1) -> Nest:
    k = Nest("atax")
    N, b = k.param("N", 12 * scale), 4
    A, x, y, tmp = (k.array("A", N, N), k.array("x", N), k.array("y", N),
                    k.array("tmp", N))
    k.inputs(A, x)
    k.outputs(y)
    with k.loop("j", 0, N) as j:
        k.stmt("yinit", writes=[y[j]])
    with k.loop("i", 0, N) as i:
        k.stmt("tinit", writes=[tmp[i]])
        with k.loop("j", 0, N) as j:
            k.stmt("tupd", writes=[tmp[i]], reads=[tmp[i], A[i, j], x[j]])
        with k.loop("j", 0, N) as j:
            k.stmt("yupd", writes=[y[j]], reads=[y[j], tmp[i], A[i, j]])
    k.tile("yinit", Tiling(((1,), (0,)), (b, b)))
    k.tile("tinit", Tiling(((1,), (0,)), (b, b)))
    k.tile("tupd", _rect(("i", "j"), ("i", "j"), b))
    k.tile("yupd", _rect(("i", "j"), ("i", "j"), b))
    return k


@register("doitgen")
def doitgen(scale: int = 1) -> Nest:
    k = Nest("doitgen")
    N, b = k.param("N", 8 * scale), 4
    A, C4 = k.array("A", N, N, N), k.array("C4", N, N)
    acc = k.array("sum", N, N, N)
    k.inputs(A, C4)
    k.outputs(A)
    with k.loop("r", 0, N) as r, k.loop("q", 0, N) as q:
        with k.loop("p", 0, N) as p:
            k.stmt("sinit", writes=[acc[r, q, p]])
            with k.loop("s", 0, N) as s:
                k.stmt("supd", writes=[acc[r, q, p]],
                       reads=[acc[r, q, p], A[r, q, s], C4[s, p]])
        with k.loop("p", 0, N) as p:
            k.stmt("aset", writes=[A[r, q, p]], reads=[acc[r, q, p]])
    k.tile("sinit", _rect(("r", "q", "p"), ("r", "q", "p", "s"), b))
    k.tile("supd", _rect(("r", "q", "p", "s"), ("r", "q", "p", "s"), b))
    k.tile("aset", _rect(("r", "q", "p"), ("r", "q", "p", "s"), b))
    return k


# ================================================================== stencils

@register("jacobi-1d")
def jacobi_1d(scale: int = 1) -> Nest:
    k = Nest("jacobi-1d")
    N, T, b = k.param("N", 16 * scale), k.param("T", 8 * scale), 4
    A, B = k.array("A", N), k.array("B", N)
    k.inputs(A)
    k.outputs(A)
    with k.loop("t", 0, T) as t:
        with k.loop("i", 1, N - 1) as i:
            k.stmt("sb", writes=[B[i]], reads=[A[i - 1], A[i], A[i + 1]])
        with k.loop("i", 1, N - 1) as i:
            k.stmt("sa", writes=[A[i]], reads=[B[i]])
    # skewed tiling: hyperplanes t and t+i (valid: all dep distances satisfy
    # τ·d ≥ 0), the paper's Fig. 3 tiling
    k.tile("sb", Tiling(((1, 0), (1, 1)), (b, b)))
    k.tile("sa", Tiling(((1, 0), (1, 1)), (b, b)))
    return k


@register("jacobi-2d")
def jacobi_2d(scale: int = 1) -> Nest:
    k = Nest("jacobi-2d")
    N, T, b = k.param("N", 10 * scale), k.param("T", 4 * scale), 4
    A, B = k.array("A", N, N), k.array("B", N, N)
    k.inputs(A)
    k.outputs(A)
    with k.loop("t", 0, T) as t:
        with k.loop("i", 1, N - 1) as i, k.loop("j", 1, N - 1) as j:
            k.stmt("sb", writes=[B[i, j]],
                   reads=[A[i, j], A[i, j - 1], A[i, j + 1],
                          A[i + 1, j], A[i - 1, j]])
        with k.loop("i", 1, N - 1) as i, k.loop("j", 1, N - 1) as j:
            k.stmt("sa", writes=[A[i, j]], reads=[B[i, j]])
    # band tiling (t, t+i) — the I/O-optimizing shape [4]: j streams inside
    t2 = Tiling(((1, 0, 0), (1, 1, 0)), (b, b))
    k.tile("sb", t2)
    k.tile("sa", t2)
    return k


@register("seidel-2d")
def seidel_2d(scale: int = 1) -> Nest:
    k = Nest("seidel-2d")
    N, T, b = k.param("N", 10 * scale), k.param("T", 4 * scale), 4
    A = k.array("A", N, N)
    k.inputs(A)
    k.outputs(A)
    with k.loop("t", 0, T) as t:
        with k.loop("i", 1, N - 1) as i, k.loop("j", 1, N - 1) as j:
            k.stmt("s", writes=[A[i, j]],
                   reads=[A[i + di, j + dj]
                          for di in (-1, 0, 1) for dj in (-1, 0, 1)])
    # dependences include (0,1,-1), (1,0,-1), (1,-1,-1) … → skewed band tiling
    k.tile("s", Tiling(((1, 0, 0), (2, 1, 1)), (b, b)))
    return k


@register("heat-3d")
def heat_3d(scale: int = 1) -> Nest:
    k = Nest("heat-3d")
    N, T, b = k.param("N", 8 * scale), k.param("T", 4 * scale), 4
    A, B = k.array("A", N, N, N), k.array("B", N, N, N)
    k.inputs(A)
    k.outputs(A)

    def star(arr, i, j, kk):
        out = [arr[i, j, kk]]
        for axis in range(3):
            for d in (-1, 1):
                idx = [i, j, kk]
                idx[axis] = idx[axis] + d
                out.append(arr[idx[0], idx[1], idx[2]])
        return out

    with k.loop("t", 0, T) as t:
        with k.loop("i", 1, N - 1) as i, k.loop("j", 1, N - 1) as j, \
                k.loop("k", 1, N - 1) as kk:
            k.stmt("sb", writes=[B[i, j, kk]], reads=star(A, i, j, kk))
        with k.loop("i", 1, N - 1) as i, k.loop("j", 1, N - 1) as j, \
                k.loop("k", 1, N - 1) as kk:
            k.stmt("sa", writes=[A[i, j, kk]], reads=star(B, i, j, kk))
    # heat-3d has same-t star reads of B (sa reads B[i±1] written by sb at the
    # same t), so the band tiling needs the Pluto-style per-statement time
    # interleave 2t / 2t+1 to stay valid: φ = ((2t+s)/b, (2t+s+i)/b).
    k.tile("sb", Tiling(((2, 0, 0, 0), (2, 1, 0, 0)), (2 * b, 2 * b), (0, 0)))
    k.tile("sa", Tiling(((2, 0, 0, 0), (2, 1, 0, 0)), (2 * b, 2 * b), (1, 1)))
    return k


# ---------------------------------------------------- the paper's Fig. 1 form

def jacobi_1d_paper(N: int = 16, T: int = 8, b1: int = 4, b2: int = 4) -> KernelCase:
    """Single-assignment Jacobi-1D exactly as Figure 1 of the paper
    (a[t][i] form, load/compute/store processes, tiling hyperplanes t and
    t+i).  Channels 1-3: load→compute, 4-6: compute→compute, 7: →store."""
    k = Nest("jacobi-1d-paper")
    n, tt = k.param("N", N), k.param("T", T)
    a = k.array("a", tt + 1, n + 2)
    with k.loop("i", 0, n + 2) as i:
        k.stmt("load", writes=[a[0, i]])
    with k.loop("t", 1, tt + 1) as t, k.loop("i", 1, n + 1) as i:
        k.stmt("compute", writes=[a[t, i]],
               reads=[a[t - 1, i - 1], a[t - 1, i], a[t - 1, i + 1]])
    with k.loop("i", 1, n + 1) as i:
        k.stmt("store", reads=[a[tt, i]])
    k.tile("compute", Tiling(((1, 0), (1, 1)), (b1, b2)))
    return k.case(compute=("compute",))
