"""Op-level cost walker: the FLOPs, bytes, collectives and peak live bytes
of one call, counted op by op as PyTorch dispatches it.

The counterpart of `repro.launch.hlo_stats`, which parses the optimized,
post-SPMD HLO text of a compiled step.  The port compiles no HLO: it runs
eagerly, so this module keeps the reference's name (a reader looking for the
counterpart finds it here) and its `HloStats`, and takes its numbers from
the ATen ops themselves.  `analyze(fn, *args, **kwargs)` calls ``fn`` under a
`TorchDispatchMode`, which sees every op that reaches the dispatcher: the
forward's, autograd's backward and remat's recompute (checkpointed layers
run again inside the backward) alike.  On ``meta`` tensors nothing is
allocated and nothing computed, so a step of any size can be walked on a
host.  Per op:

    flops             matmuls, convolutions and SDPA by the formulas
                      `torch.utils.flop_counter` registers (2·M·N·K for a
                      product), +1 per output element for every other op,
                      as the reference counts non-dot instructions; nothing
                      for views, ``detach`` or ``empty`` (a tensor made
                      without computing it), and copies (``copy_``,
                      ``clone``, a ``_to_copy`` that keeps the dtype) carry
                      bytes and no FLOPs, as the reference's ``copy``
    bytes             operand plus result bytes of every op that is not a
                      view.  Eager PyTorch fuses nothing, so every
                      intermediate goes through memory, where the
                      reference's count stops at XLA's fusion boundaries;
                      but a view reads nothing, where the reference's count
                      also charges a loop's carried buffers, its dynamic
                      slices (twice) and whole stacked operands read inside
                      it.  So neither count bounds the other: on a 4-layer
                      scan of ``tanh(c @ w)`` this one is 0.60 of the
                      reference's, on device 0 of qwen2-7b's decode,
                      prefill and train step (B = 4, S = 256, a 2×2 mesh)
                      0.26, 0.38 and 1.23 (`tests/test_torch_launch.py`)
    collective bytes  the collectives ``fn`` issues: the c10d ops
                      (all-reduce, all-gather, reduce-scatter, all-to-all,
                      and a ``send`` as a collective-permute, whose
                      ``recv`` end is its peer's) and the functional ones
                      DTensor issues (``_c10d_functional``, and
                      ``_dtensor.shard_dim_alltoall`` as an all-to-all),
                      the operand's bytes times the reference's ring factor
                      for the group's size: all-gather g−1, all-reduce
                      2(g−1)/g, reduce-scatter and all-to-all (g−1)/g,
                      collective-permute 1.  A collective has no FLOPs; its
                      bytes are the tensors it reads and writes;
                      ``wait_tensor`` has neither
    peak live bytes   the most bytes held at once by storages that ops made
                      during the call, less those the call returns (the
                      dry run's temp bytes)

Python loops run unrolled, so a layer loop is counted as often as it runs:
the property the reference recovers from each ``while`` loop's trip count
holds by construction.  `HloStats.loops` is left for the caller to fill
where the model exposes its loop (the dry run records the layer count).
Every number is for the whole call on the device its arguments' tensors
are on; ops on no tensor of that device are the host's and are not
counted.

A DTensor's op is handed back to DTensor (the walker returns
``NotImplemented`` for it), which redistributes its operands, issuing
functional collectives, and runs the local op on this rank's blocks: both
come back to the walker, so on a DeviceMesh over a fake process group
(`repro_torch.launch.mesh.fake_device_mesh`) a call is counted as rank 0
runs it.  The ops DTensor runs on fake tensors to work out shapes are not
counted.
"""
from __future__ import annotations

import weakref
from array import array
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, is_traceable_wrapper_subclass,
    is_traceable_wrapper_subclass_type)
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten

#: ops that make a tensor without computing it: no FLOPs, no bytes
_NO_COST = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.detach.default,
    _aten._unsafe_view.default, _aten.lift_fresh.default,
}
#: copies: bytes and no FLOPs (a ``_to_copy`` that changes the dtype is a
#: convert, an ordinary op)
_COPIES = {_aten.copy_.default, _aten.clone.default, _aten._to_copy.default}

#: c10d ops: (the reference's collective, the argument holding the operand)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}
#: functional collectives, the ops DTensor issues, by namespace and name:
#: the reference's collective (each reads its first argument, a tensor or a
#: list of them, and returns a new one; ``wait_tensor`` and the autograd
#: wrappers move nothing)
_FUNCTIONAL = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    # a Shard(i) -> Shard(j) redistribute on a mesh that is not the CPU's
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
}
#: the namespaces of collective ops: none has FLOPs
_COLLECTIVE_NS = frozenset({"c10d", "_c10d_functional",
                            "_c10d_functional_autograd", "_dtensor"})


def _ring_factor(kind: str, g: int) -> float:
    """Wire traffic per device of a ring algorithm over a group of ``g``,
    as a multiple of the operand's bytes (the reference's factors)."""
    return {"all-gather": g - 1,
            "all-reduce": 2 * (g - 1) / max(g, 1),
            "reduce-scatter": (g - 1) / max(g, 1),
            "all-to-all": (g - 1) / max(g, 1),
            "collective-permute": 1.0}[kind]


def _tensors(x):
    """The tensors in an op's arguments or results (lists nested once or
    twice, as c10d's lists of lists)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for a in x:
            yield from _tensors(a)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(args) -> int:
    """The process group's size from a c10d op's arguments: the group is
    the first boxed object among them, after the tensors."""
    import torch.distributed as dist
    group = next(a for a in args if isinstance(a, torch.ScriptObject))
    return dist.ProcessGroup.unbox(group).size()


def _named_group_size(args) -> int:
    """The process group's size from a functional collective's arguments:
    the group is named by its last argument, a string (or the group)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = args[-1]
    return (_resolve_process_group(group) if isinstance(group, str)
            else group).size()


@dataclass
class HloStats:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)
    loops: List[Tuple[str, int]] = field(default_factory=list)
    #: not a reference field: the peak of live intermediate bytes
    peak_live_bytes: float = 0.0

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "per_collective": dict(self.per_collective),
                "collective_count": dict(self.collective_count),
                "loops": list(self.loops)}


def _pure(func) -> bool:
    """An op that writes none of its inputs and returns only fresh tensors:
    its result's shapes follow from its arguments' alone."""
    schema = func._schema
    return (not schema.is_mutable
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in schema.returns))


#: the argument types `_signature` takes by value
_SCALARS = frozenset({bool, int, float, str, type(None), torch.dtype,
                      torch.device, torch.memory_format, torch.layout})


def _signature(x):
    """A hashable summary of an op's argument: a tensor by its shape,
    strides, dtype and device, a scalar by its value; ``TypeError`` where
    an argument has none."""
    if isinstance(x, torch.Tensor):
        return x.shape, x.stride(), x.dtype, x.device.type
    t = type(x)
    if t in _SCALARS:
        return t, x
    if t is list or t is tuple:
        return tuple([_signature(a) for a in x])
    raise TypeError(t)


#: op -> `_pure(op)`
_PURE: Dict = {}
#: a pure op's `_key` -> (its ``meta`` results' shapes, strides and dtypes,
#: its cost)
_SEEN: Dict = {}


def _key(func, args, kwargs):
    """The key of a pure op's call (the op and its arguments' signatures),
    or None where the op is not pure or an argument has no signature."""
    pure = _PURE.get(func)
    if pure is None:
        pure = _PURE[func] = _pure(func)
    if not pure:
        return None
    try:
        return func, _signature(args), _signature(tuple(kwargs.items()))
    except TypeError:
        return None


class _Walker(TorchDispatchMode):
    """Counts each dispatched op into ``stats`` and logs each storage an op
    makes (+bytes) and frees (−bytes), tagged with a serial number.

    A pure op (`_pure`) on ``meta`` tensors is run once for each signature
    of its arguments: its result's shapes, strides and cost are kept, and a
    later call with the same signature gets new ``meta`` tensors of those
    shapes (PyTorch computes many ``meta`` results in Python, at about 0.1
    ms an op; a model repeats the same ops layer after layer, and the cells
    of a dry run repeat each other's).  What is kept depends on the
    arguments alone, so it is kept across calls."""

    def __init__(self, stats: HloStats, device: Optional[str] = None):
        super().__init__()
        self.stats = stats
        #: the device type of the program: ops on no tensor of it are the
        #: host's (DTensor's own index arithmetic) and are not counted
        self.device = device
        self.serial = 0
        self.live: Dict[int, int] = {}       # storage key -> serial
        self.tags = array("q")               # serial of each event
        self.sizes = array("q")              # +bytes made, -bytes freed

    def _freed(self, key: int, serial: int, nbytes: int) -> None:
        if self.live.get(key) == serial:
            del self.live[key]
        self.tags.append(serial)
        self.sizes.append(-nbytes)

    def _made(self, out, inputs: set) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or key in self.live:
                continue
            self.serial += 1
            self.live[key] = self.serial
            n = st.nbytes()
            self.tags.append(self.serial)
            self.sizes.append(n)
            weakref.finalize(st, self._freed, key, self.serial, n)

    def _collective(self, func, args, kwargs):
        """Run a collective op: the reference's collective it is, counted
        with its ring factor, the tensors it reads and writes as bytes, and
        no FLOPs."""
        ns, name = func.namespace, func._overloadpacket.__name__
        if ns == "c10d":
            entry = _C10D.get(name)
            if entry is not None:
                kind, at = entry
                self._wire(kind, _nbytes(args[at]), _group_size(args))
                self._count(0, _nbytes(args))
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        kind = _FUNCTIONAL.get((ns, name))
        if kind is not None:
            self._wire(kind, _nbytes(args[0]), _named_group_size(args))
            self._count(0, _nbytes(args[0]) + _nbytes(out))
            self._made(out, set())
        return out

    def _wire(self, kind: str, operand: int, g: int) -> None:
        cb = operand * _ring_factor(kind, g)
        st = self.stats
        st.collective_bytes += cb
        st.per_collective[kind] = st.per_collective.get(kind, 0.0) + cb
        st.collective_count[kind] = st.collective_count.get(kind, 0) + 1

    def _cost(self, func, args, kwargs, out) -> Tuple[float, int]:
        nbytes = (_nbytes(args) + _nbytes(list(kwargs.values()))
                  + _nbytes(out))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            return formula(*args, **kwargs, out_val=out), nbytes
        if func not in _COPIES or (
                func is _aten._to_copy.default
                and kwargs.get("dtype", args[0].dtype) != args[0].dtype):
            return sum(t.numel() for t in _tensors(out)), nbytes
        return 0, nbytes

    def _count(self, flops: float, nbytes: int) -> None:
        self.stats.flops += flops
        self.stats.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is not torch.Tensor for t in types):
            if any(map(is_traceable_wrapper_subclass_type, types)):
                # a DTensor: its own dispatch runs the local ops, which
                # come back here and are counted at their shapes
                return NotImplemented
            # a FakeTensor: DTensor's sharding propagation working out
            # shapes, which no device runs
            return func(*args, **(kwargs or {}))
        kwargs = kwargs or {}
        if func.namespace in _COLLECTIVE_NS:
            return self._collective(func, args, kwargs)
        if func.is_view or func in _NO_COST:
            return func(*args, **kwargs)
        sig = _key(func, args, kwargs)
        hit = _SEEN.get(sig) if sig is not None else None
        if hit is not None:
            results, cost = hit
            out = tuple(torch.empty_strided(size, stride, dtype=dt,
                                            device="meta")
                        for size, stride, dt in results)
            out = out[0] if len(out) == 1 else out
            self._count(*cost)
            self._made(out, set())
            return out
        inputs = {t.untyped_storage()._cdata for t in _tensors(args)}
        inputs.update(t.untyped_storage()._cdata
                      for t in _tensors(list(kwargs.values())))
        out = func(*args, **kwargs)
        if self.device is not None and not any(
                t.device.type == self.device
                for t in _tensors([out, args, list(kwargs.values())])):
            return out
        cost = self._cost(func, args, kwargs, out)
        self._count(*cost)
        self._made(out, inputs)
        outs = out if isinstance(out, tuple) else (out,)
        if sig is not None and all(
                isinstance(t, torch.Tensor) and t.device.type == "meta"
                and t.storage_offset() == 0
                and t.untyped_storage().nbytes()
                == t.numel() * t.element_size() for t in outs):
            _SEEN[sig] = (tuple((tuple(t.shape), t.stride(), t.dtype)
                                for t in outs), cost)
        return out

    def peak(self, exclude: set) -> int:
        """The most bytes live at once, leaving out the storages whose
        serials are in ``exclude``."""
        live = peak = 0
        for tag, size in zip(self.tags, self.sizes):
            if tag not in exclude:
                live += size
                peak = max(peak, live)
        return peak


def _leaves(tree):
    """The tensors of a tree of dicts, lists and tuples, a DTensor as its
    local block."""
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif is_traceable_wrapper_subclass(x):      # a DTensor: its block
            stack.extend(getattr(x, n) for n in x.__tensor_flatten__()[0])
        elif isinstance(x, torch.Tensor):
            yield x


def analyze(fn, *args, **kwargs) -> HloStats:
    """Call ``fn(*args, **kwargs)`` under the walker and return what it
    counted: the ops on the device of its arguments' tensors (every op
    where it has none).  ``peak_live_bytes`` leaves out the storages of
    the tensors ``fn`` returns that cover their whole storage (a returned
    view of a larger intermediate keeps that intermediate counted)."""
    stats = HloStats()
    first = next(_leaves([args, kwargs]), None)
    walker = _Walker(stats, None if first is None else first.device.type)
    with walker:
        out = fn(*args, **kwargs)
    returned = set()
    for x in _leaves(out):
        st = x.untyped_storage()
        serial = walker.live.get(st._cdata)
        if serial is not None and (x.numel() * x.element_size()
                                   == st.nbytes()):
            returned.add(serial)
    stats.peak_live_bytes = float(walker.peak(returned))
    del out
    return stats
