"""Declarative loop-nest builder: author kernels, compile to `Kernel`.

The polyhedral pipeline (PPN construction → tiling → FIFO recovery → sizing)
consumes affine kernel specs; hand-assembling them means raw `Statement` /
`Constraint` tuples, hand-numbered 2d+1 schedule constants, and copy-pasted
load/store boilerplate.  `Nest` replaces all of that:

    from repro_torch.lang import Nest

    k = Nest("gemm")
    C, A, B = k.array("C", N, N), k.array("A", N, N), k.array("B", N, N)
    k.inputs(C, A, B)               # load_* boundary processes (prologue)
    k.outputs(C)                    # store_* boundary processes (epilogue)
    with k.loop("i", 0, N) as i, k.loop("j", 0, N) as j:
        k.stmt("init", writes=[C[i, j]], reads=[C[i, j]])
        with k.loop("k", 0, N) as kk:
            k.stmt("upd", writes=[C[i, j]],
                   reads=[C[i, j], A[i, kk], B[kk, j]])
    k.tile("upd", some_tiling)      # per-statement tiling attachment
    report = analyze(k).classify().fifoize().size().report()

* **Index expressions** are operator-overloaded affine arithmetic over loop
  iterators (`A[i, kk]`, `a[t - 1, i + 1]`, `B[2 * i + 1]`).  A non-affine
  product (`A[i * j]`) degrades to a poison value the validation pass reports
  with the offending statement — never a mid-expression numpy error.
* **Schedules** are assigned automatically from program order: the loop tree
  yields the classic 2d+1 timestamp (position constants interleaved with the
  loop counters), so there is nothing to hand-number and nothing to collide —
  unless positions are pinned explicitly with ``at=`` (for composing
  fragments), which the validation pass cross-checks.
* **Boundary processes** are derived from the declared I/O: `inputs()`
  arrays get a ``load_<name>`` process in the prologue phase, `outputs()`
  arrays a ``store_<name>`` process in the epilogue phase, with domains from
  the declared array shapes and schedules from
  `repro_torch.core.schedule.boundary_schedule` (prologue ≪ body ≪ epilogue under
  ANY tiling — the phase constant leads the timestamp).  When `inputs()` is
  not called, arrays whose first access in program order is a read are
  loaded, in first-read order.
* **Validation** (`validate()` collects, `build()` raises `SpecError`)
  rejects malformed specs with diagnostics naming the offending statement:
  non-affine accesses, out-of-scope iterators, schedule collisions, empty or
  unbounded iteration domains, arity mismatches, unknown tiling targets,
  mismatched tiling widths, duplicate statement names.

`case()` packages the compiled kernel as a `KernelCase`; `__kernelcase__()`
is the protocol `analyze()` / `sweep()` / the kernel registry use to accept
builder programs directly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core.affine import Constraint, LinExpr, ge, lt, v
from ..core.dataflow import Access, Kernel, Statement
from ..core.polyhedron import Polyhedron
from ..core.registry import KernelCase
from ..core.schedule import (AffineSchedule, PROLOGUE_C0, boundary_schedule,
                             epilogue_c0)
from ..core.tiling import Tiling


class SpecError(ValueError):
    """A kernel spec failed validation; ``diagnostics`` lists every problem
    found (each naming the offending statement or loop)."""

    def __init__(self, diagnostics: Sequence[str]):
        self.diagnostics = list(diagnostics)
        super().__init__("invalid kernel spec:\n  "
                         + "\n  ".join(self.diagnostics))


class NonAffine:
    """Poison value produced by non-affine arithmetic (e.g. ``i * j``): it
    absorbs further arithmetic so expression building never raises; the
    validation pass reports it with the statement that used it."""

    __slots__ = ("reason",)

    def __init__(self, reason: str):
        self.reason = reason

    def _absorb(self, *_args) -> "NonAffine":
        return self

    __add__ = __radd__ = __sub__ = __rsub__ = _absorb
    __mul__ = __rmul__ = __neg__ = _absorb

    def __repr__(self) -> str:
        return f"<non-affine: {self.reason}>"


def _coerce(x) -> Union[LinExpr, NonAffine]:
    """Affine coercion that degrades to poison instead of raising."""
    if isinstance(x, NonAffine):
        return x
    if isinstance(x, bool) or isinstance(x, float):
        if isinstance(x, float) and x.is_integer():
            return LinExpr.const_expr(int(x))
        return NonAffine(f"{x!r} is not an integer")
    try:
        return LinExpr.coerce(x)
    except TypeError:
        return NonAffine(f"{x!r} is not an affine expression")


class AffExpr(LinExpr):
    """`LinExpr` with closed operator overloading for the builder: affine
    combinations stay `AffExpr`; products of two non-constant expressions
    (and non-integer operands) degrade to :class:`NonAffine` poison."""

    __slots__ = ()

    @staticmethod
    def _of(e: LinExpr) -> "AffExpr":
        out = AffExpr.__new__(AffExpr)
        out.coeffs = e.coeffs
        out.const = e.const
        return out

    @staticmethod
    def var(name: str, coeff: int = 1) -> "AffExpr":
        return AffExpr._of(LinExpr.var(name, coeff))

    def __add__(self, other):
        other = _coerce(other)
        if isinstance(other, NonAffine):
            return other
        return AffExpr._of(LinExpr.__add__(self, other))

    __radd__ = __add__

    def __neg__(self) -> "AffExpr":
        return AffExpr._of(LinExpr.__neg__(self))

    def __sub__(self, other):
        other = _coerce(other)
        if isinstance(other, NonAffine):
            return other
        return self + (-other)

    def __rsub__(self, other):
        other = _coerce(other)
        if isinstance(other, NonAffine):
            return other
        return AffExpr._of(other) + (-self)

    def __mul__(self, k):
        if isinstance(k, NonAffine):
            return k
        if isinstance(k, LinExpr):
            if k.coeffs and self.coeffs:
                return NonAffine(f"({self}) * ({k})")
            if k.coeffs:                    # self is a constant
                return AffExpr._of(LinExpr.__mul__(k, self.const))
            k = k.const
        if isinstance(k, float):
            if not k.is_integer():
                return NonAffine(f"({self}) * {k!r}")
            k = int(k)
        if not isinstance(k, int):
            return NonAffine(f"({self}) * {k!r}")
        return AffExpr._of(LinExpr.__mul__(self, k))

    __rmul__ = __mul__


@dataclass(frozen=True)
class ArrayRef:
    """A declared array: its name and shape.  Subscription builds an
    :class:`AccessRef` — ``A[i, j + 1]`` — for `Nest.stmt` read/write lists;
    the declared shape is also the domain of the derived boundary process."""

    name: str
    shape: Tuple[object, ...]      # int extents, or LinExpr over parameters

    def __getitem__(self, idx) -> "AccessRef":
        return AccessRef(self, idx if isinstance(idx, tuple) else (idx,))

    def __repr__(self) -> str:
        return f"{self.name}{list(self.shape)}"


@dataclass(frozen=True)
class AccessRef:
    """An array subscription as written by the author — indices are kept raw
    (affine expressions, ints, or poison) until `Nest.stmt` validates them."""

    array: ArrayRef
    idx: Tuple[object, ...]

    def __repr__(self) -> str:
        return f"{self.array.name}[{', '.join(map(repr, self.idx))}]"


@dataclass
class _OpenLoop:
    name: str
    cons: List[Constraint]
    position: int
    children: List[Tuple[int, str]] = field(default_factory=list)
    auto: int = 0


@dataclass
class _BodyStmt:
    name: str
    dims: Tuple[str, ...]
    domain: List[Constraint]
    path: Tuple[int, ...]                  # positions: one per level + own
    writes: List[Access]
    reads: List[Access]


class _LoopCtx:
    """Context manager returned by `Nest.loop`; registration (parent,
    position, bound validation) happens at ``__enter__`` so the loop tree
    mirrors the actual ``with`` nesting."""

    def __init__(self, nest: "Nest", name: str, lo, hi, at: Optional[int]):
        self._nest, self._name = nest, name
        self._lo, self._hi, self._at = lo, hi, at

    def __enter__(self) -> AffExpr:
        return self._nest._enter_loop(self._name, self._lo, self._hi,
                                      self._at)

    def __exit__(self, *exc) -> None:
        self._nest._exit_loop()


class Nest:
    """One kernel under construction — see the module docstring for the
    authoring model and `build()` / `case()` for the compiled products."""

    def __init__(self, name: str):
        self.name = name
        self._params: Dict[str, int] = {}
        self._arrays: Dict[str, ArrayRef] = {}
        self._stack: List[_OpenLoop] = []
        self._all_loops: List[_OpenLoop] = []
        self._root = _OpenLoop("<program>", [], -1)
        self._stmts: List[_BodyStmt] = []
        self._inputs: Optional[List[str]] = None
        self._outputs: List[str] = []
        self._tilings: Dict[str, Tiling] = {}
        self._diags: List[str] = []
        self._kernel: Optional[Kernel] = None

    # ------------------------------------------------------------ authoring

    def param(self, name: str, default: int) -> AffExpr:
        """Declare a symbolic size parameter with its concrete default.

        The returned expression composes into loop bounds, array extents and
        where-clauses like any iterator.  The default is baked into the
        compiled ``Kernel.params`` so every concrete path (enumeration,
        validation, golden fixtures) behaves exactly as if the sizes were
        literal; parametric analysis (``analyze(k, sizes=symbolic)``) keeps
        the name symbolic instead."""
        d = int(default)
        if name in self._params:
            if self._params[name] != d:
                self._diags.append(
                    f"parameter {name!r}: redeclared with a different "
                    f"default ({self._params[name]} vs {d})")
            return AffExpr.var(name)
        if d <= 0:
            self._diags.append(f"parameter {name!r}: default must be "
                               f"positive (got {d})")
        self._params[name] = d
        self._kernel = None
        return AffExpr.var(name)

    def array(self, name: str, *shape) -> ArrayRef:
        """Declare an array with its extents (each dimension ``[0, ext)``).
        Extents are integers or affine expressions over declared
        parameters."""
        if name in self._arrays:
            raise ValueError(f"array {name!r} already declared")
        exts: List[object] = []
        for e in shape:
            co = _coerce(e)
            if isinstance(co, NonAffine):
                self._diags.append(f"array {name!r}: non-affine extent "
                                   f"{co.reason}")
                exts.append(1)
            elif co.coeffs:
                bad = [nm for nm in co.vars() if nm not in self._params]
                if bad:
                    self._diags.append(
                        f"array {name!r}: extent {co!r} references "
                        f"non-parameter variable"
                        f"{'s' if len(bad) > 1 else ''} "
                        + ", ".join(map(repr, bad)))
                exts.append(co)
            else:
                exts.append(int(co.const))
        ref = ArrayRef(name, tuple(exts))
        self._arrays[name] = ref
        self._kernel = None
        return ref

    def loop(self, name: str, lo, hi, at: Optional[int] = None) -> _LoopCtx:
        """Open a loop ``for name in [lo, hi)`` (bounds affine in outer
        iterators); use as ``with k.loop("i", 0, N) as i:``.  ``at=`` pins
        the loop's program-order position among its siblings."""
        return _LoopCtx(self, name, lo, hi, at)

    def stmt(self, name: str, writes=None, reads=None,
             where: Sequence[Constraint] = (),
             at: Optional[int] = None) -> str:
        """Add a statement at the current loop nesting.  ``writes`` /
        ``reads`` are access lists (`A[i, j]`-style, a single access is
        accepted bare); ``where`` adds extra affine guards to the domain;
        ``at=`` pins the program-order position.  Returns the statement name
        (the handle `tile()` takes)."""
        if any(s.name == name for s in self._stmts):
            self._diags.append(f"statement {name!r}: duplicate statement "
                               f"name")
        parent = self._stack[-1] if self._stack else self._root
        position = self._place(parent, name, at)
        dims = tuple(l.name for l in self._stack)
        domain = [c for l in self._stack for c in l.cons]
        for c in where:
            if not isinstance(c, Constraint):
                self._diags.append(f"statement {name!r}: where-clause entry "
                                   f"{c!r} is not a Constraint")
                continue
            self._check_scope(name, c.expr, f"where-clause {c!r}", dims)
            domain.append(c)
        out = _BodyStmt(name, dims, domain,
                        tuple([l.position for l in self._stack] + [position]),
                        self._accesses(name, "write", writes, dims),
                        self._accesses(name, "read", reads, dims))
        self._stmts.append(out)
        self._kernel = None
        return name

    def inputs(self, *arrays: Union[ArrayRef, str]) -> "Nest":
        """Declare the loaded arrays, in load order (each becomes a
        ``load_<name>`` prologue process).  Without this call, arrays whose
        first access in program order is a read are loaded, in first-read
        order."""
        self._inputs = [self._array_name("inputs", a) for a in arrays]
        self._kernel = None
        return self

    def outputs(self, *arrays: Union[ArrayRef, str]) -> "Nest":
        """Declare the stored arrays, in store order (each becomes a
        ``store_<name>`` epilogue process).  Liveness is not derivable from
        the spec, so outputs are always explicit."""
        self._outputs = [self._array_name("outputs", a) for a in arrays]
        self._kernel = None
        return self

    def tile(self, stmt: str, tiling: Tiling) -> "Nest":
        """Attach a `Tiling` to one statement (the per-statement embedding
        into the common tile space — see `core.tiling.Tiling`)."""
        self._tilings[str(stmt)] = tiling
        self._kernel = None
        return self

    # ----------------------------------------------------------- internals

    def _array_name(self, who: str, a: Union[ArrayRef, str]) -> str:
        name = a.name if isinstance(a, ArrayRef) else str(a)
        if name not in self._arrays:
            self._diags.append(f"{who}: unknown array {name!r} (declare it "
                               f"with Nest.array first)")
        return name

    def _place(self, parent: _OpenLoop, name: str, at: Optional[int]) -> int:
        if at is None:
            position = parent.auto
            parent.auto += 1
        else:
            position = int(at)
            if position < 0 and parent is self._root:
                # only the ROOT position becomes the schedule's leading c0;
                # keeping it non-negative reserves the prologue phase
                # (c0 = PROLOGUE_C0) for derived load processes.  Interior
                # positions may go negative freely (ordering before auto-
                # positioned siblings).
                self._diags.append(
                    f"{name!r}: top-level position at={position} is "
                    f"negative (negative phases are reserved for derived "
                    f"load processes)")
            parent.auto = max(parent.auto, position + 1)
        parent.children.append((position, name))
        return position

    def _enter_loop(self, name: str, lo, hi, at: Optional[int]) -> AffExpr:
        parent = self._stack[-1] if self._stack else self._root
        open_names = tuple(l.name for l in self._stack)
        if name in open_names:
            self._diags.append(f"loop {name!r}: shadows an open loop of the "
                               f"same name (open loops: "
                               f"{', '.join(open_names)})")
        if name in self._params:
            self._diags.append(f"loop {name!r}: shadows the parameter of "
                               f"the same name")
        cons: List[Constraint] = []
        bounds = []
        for label, bound in (("lower", lo), ("upper", hi)):
            e = _coerce(bound)
            if isinstance(e, NonAffine):
                self._diags.append(f"loop {name!r}: non-affine {label} "
                                   f"bound {e.reason}")
                e = LinExpr.const_expr(0)
            else:
                self._check_scope(f"loop {name!r}", e,
                                  f"{label} bound", open_names, kind="loop")
            bounds.append(e)
        cons.append(ge(v(name), bounds[0]))
        cons.append(lt(v(name), bounds[1]))
        position = self._place(parent, name, at)
        record = _OpenLoop(name, cons, position)
        self._stack.append(record)
        self._all_loops.append(record)
        self._kernel = None
        return AffExpr.var(name)

    def _exit_loop(self) -> None:
        self._stack.pop()

    def _check_scope(self, owner: str, expr: LinExpr, what: str,
                     dims: Sequence[str], kind: str = "statement") -> None:
        for name in expr.vars():
            if name not in dims and name not in self._params:
                scope = ", ".join(dims) if dims else "none"
                label = owner if kind == "loop" else f"statement {owner!r}"
                self._diags.append(
                    f"{label}: {what} references out-of-scope iterator "
                    f"{name!r} (open loops: {scope})")

    def _accesses(self, stmt: str, what: str, refs,
                  dims: Sequence[str]) -> List[Access]:
        if refs is None:
            return []
        if isinstance(refs, AccessRef):
            refs = [refs]
        out: List[Access] = []
        for ref in refs:
            if not isinstance(ref, AccessRef):
                self._diags.append(f"statement {stmt!r}: {what} {ref!r} is "
                                   f"not an array access (use A[i, j])")
                continue
            arr = ref.array
            if self._arrays.get(arr.name) is not arr:
                self._diags.append(f"statement {stmt!r}: {what} of array "
                                   f"{arr.name!r} not declared on this Nest")
            if len(ref.idx) != len(arr.shape):
                self._diags.append(
                    f"statement {stmt!r}: {what} {ref!r} has "
                    f"{len(ref.idx)} indices for {len(arr.shape)}-d array "
                    f"{arr.name!r}")
            fn: List[LinExpr] = []
            for ix in ref.idx:
                e = _coerce(ix)
                if isinstance(e, NonAffine):
                    self._diags.append(f"statement {stmt!r}: non-affine "
                                       f"index {e.reason} in {what} {ref!r}")
                    e = LinExpr.const_expr(0)
                else:
                    self._check_scope(stmt, e, f"{what} {ref!r}", dims)
                fn.append(e)
            out.append(Access(arr.name, tuple(fn)))
        return out

    # ---------------------------------------------------------- validation

    def validate(self) -> List[str]:
        """Every diagnostic for the spec as authored so far (empty = valid).
        `build()` raises `SpecError` listing these instead of letting a
        malformed spec surface as a downstream numpy error."""
        diags = list(self._diags)
        if self._stack:
            diags.append(f"loop {self._stack[-1].name!r}: still open at "
                         f"build time (build() inside the with-block?)")
        diags += self._collision_diags()
        diags += self._domain_diags()
        body_names = {s.name for s in self._stmts}
        for name, tiling in self._tilings.items():
            if name not in body_names:
                diags.append(f"tiling attached to unknown statement "
                             f"{name!r}")
                continue
            stmt = next(s for s in self._stmts if s.name == name)
            for row in tiling.normals:
                if len(row) != len(stmt.dims):
                    diags.append(
                        f"statement {name!r}: tiling normal {tuple(row)} "
                        f"has {len(row)} entries for {len(stmt.dims)} loop "
                        f"dims {stmt.dims}")
        seen_boundary: set = set()
        for bname in self._boundary_names():
            if bname in body_names:
                diags.append(f"statement {bname!r}: name collides with a "
                             f"derived boundary process")
            if bname in seen_boundary:
                diags.append(f"boundary process {bname!r} duplicated (array "
                             f"listed more than once in inputs()/outputs())")
            seen_boundary.add(bname)
        return diags

    def _collision_diags(self) -> List[str]:
        """Two siblings pinned (via ``at=``) to the same program-order
        position have colliding schedules — the program order is ambiguous."""
        diags: List[str] = []
        for cont in [self._root] + self._all_loops:
            seen: Dict[int, str] = {}
            for position, child in cont.children:
                if position in seen:        # same-named siblings collide too
                    diags.append(
                        f"schedule collision under "
                        f"{'the program' if cont is self._root else f'loop {cont.name!r}'}: "
                        f"{seen[position]!r} and {child!r} both at "
                        f"position {position}")
                seen.setdefault(position, child)
        return diags

    def _domain_diags(self) -> List[str]:
        diags: List[str] = []
        # validate at the parameter defaults: the spec checks (emptiness,
        # boundedness) are concrete-size questions and the defaults are the
        # sizes every concrete path will use
        env = {p: LinExpr.const_expr(d) for p, d in self._params.items()}
        for s in self._stmts:
            dom = ([c.substitute(env) for c in s.domain] if env
                   else s.domain)
            poly = Polyhedron(dom)
            if poly.is_empty():
                diags.append(f"statement {s.name!r}: empty iteration domain "
                             f"(no integer point satisfies its bounds)")
                continue
            if s.dims:
                try:
                    box = poly.bounding_box()
                    unbounded = [d for d in s.dims if d not in box]
                except ValueError:
                    # a ray leaked — usually a free variable from an
                    # out-of-scope reference (diagnosed above), so don't
                    # blame the (possibly well-bounded) loop iterators
                    diags.append(f"statement {s.name!r}: iteration domain "
                                 f"has an unbounded direction (does a bound "
                                 f"or where-clause reference a free "
                                 f"variable?)")
                    continue
                if unbounded:
                    diags.append(f"statement {s.name!r}: iterator"
                                 f"{'s' if len(unbounded) > 1 else ''} "
                                 f"{', '.join(map(repr, unbounded))} "
                                 f"unbounded (every loop needs finite "
                                 f"bounds)")
        return diags

    # ---------------------------------------------------------- compilation

    def _boundary_names(self) -> List[str]:
        return ([f"load_{a}" for a in self._derived_inputs()]
                + [f"store_{a}" for a in self._outputs])

    def _derived_inputs(self) -> List[str]:
        if self._inputs is not None:
            return list(self._inputs)
        first: Dict[str, str] = {}
        for s in sorted(self._stmts, key=lambda s: s.path):
            for acc in s.reads:
                first.setdefault(acc.array, "read")
            for acc in s.writes:
                first.setdefault(acc.array, "write")
        return [a for a, kind in first.items() if kind == "read"]

    def _schedule(self, s: _BodyStmt) -> AffineSchedule:
        """The 2d+1 timestamp from program order: position constants
        interleaved with the loop counters — nothing hand-numbered."""
        exprs: List[LinExpr] = [LinExpr.const_expr(s.path[0])]
        for level, dim in enumerate(s.dims):
            exprs.append(LinExpr.var(dim))
            exprs.append(LinExpr.const_expr(s.path[level + 1]))
        return AffineSchedule(s.dims, exprs)

    def _boundary(self, arr: str, rank: int, c0: int,
                  prefix: str) -> Statement:
        shape = self._arrays[arr].shape
        dims = tuple(f"{prefix[0]}{k}" for k in range(len(shape)))
        dom: List[Constraint] = []
        for d, ext in zip(dims, shape):
            dom += [ge(v(d), LinExpr.const_expr(0)),
                    lt(v(d), LinExpr.coerce(ext))]
        access = [Access(arr, tuple(LinExpr.var(d) for d in dims))]
        kwargs = ({"writes": access} if prefix == "load" else
                  {"reads": access})
        return Statement(f"{prefix}_{arr}", dims, dom,
                         boundary_schedule(dims, c0, rank), **kwargs)

    def build(self) -> Kernel:
        """Validate and compile to a `Kernel` (cached until the spec is
        touched again); raises `SpecError` on any diagnostic."""
        if self._kernel is not None:
            return self._kernel
        diags = self.validate()
        if diags:
            raise SpecError(diags)
        loads = [self._boundary(a, rank, PROLOGUE_C0, "load")
                 for rank, a in enumerate(self._derived_inputs())]
        body = [Statement(s.name, s.dims, list(s.domain), self._schedule(s),
                          writes=list(s.writes), reads=list(s.reads))
                for s in self._stmts]
        epi = epilogue_c0(p for p, _ in self._root.children)
        stores = [self._boundary(a, rank, epi, "store")
                  for rank, a in enumerate(self._outputs)]
        self._kernel = Kernel(self.name, dict(self._params),
                              loads + body + stores,
                              arrays={n: r.shape
                                      for n, r in self._arrays.items()})
        return self._kernel

    # ----------------------------------------------------------- packaging

    @property
    def kernel(self) -> Kernel:
        return self.build()

    @property
    def tilings(self) -> Dict[str, Tiling]:
        return dict(self._tilings)

    def case(self, compute: Optional[Sequence[str]] = None,
             notes: str = "") -> KernelCase:
        """Package as a `KernelCase`; ``compute`` defaults to every body
        statement in program order (the processes the paper's tables count
        channels between)."""
        kernel = self.build()
        if compute is None:
            compute = tuple(s.name for s in self._stmts)
        return KernelCase(kernel, dict(self._tilings), tuple(compute), notes)

    def __kernelcase__(self) -> KernelCase:
        """Protocol hook: `analyze()` / `sweep()` / the kernel registry call
        this to accept builder programs directly."""
        return self.case()
