"""Logical-axis sharding rules with divisibility fallback.

The port of `repro.models.sharding`.  Tensors are annotated with *logical*
axis names; a `Rules` object (derived from the arch's ParallelConfig + the
mesh) maps them to mesh axes.  When a dimension does not divide the mapped
mesh axes' product (e.g. smollm's 9 heads on a 16-way model axis), axes are
dropped from the right until it does — the fallback is recorded in
``dropped``, so a report can say where TP degenerated.

`Rules.spec` returns a tuple with one part per dimension (None, an axis
name or a tuple of names) where the reference returns a ``PartitionSpec``.
The mesh is one of two things:

* a mapping of axis sizes, such as ``{"data": 1, "model": 1}``: the
  one-device path, and the dry run's production meshes.  Nothing is laid
  out: `constrain` returns its input on one device and raises on more,
  where a mapping has no devices to lay a tensor out on.
* a `torch.distributed.device_mesh.DeviceMesh` with named axes (``("data",
  "model")`` or ``("pod", "data", "model")``): the sharded path.  Every
  tensor of a step is a ``DTensor``; `placements` turns a spec into its
  placements, `distribute` lays a full tensor out (the reference's
  ``sharding`` plus ``device_put``), and `constrain` redistributes a DTensor
  to its spec, as ``with_sharding_constraint`` does.

A spec part that names two mesh axes against the mesh's order (``"wtp2"`` =
tp + fsdp = ``("model", "data")`` on a ``("data", "model")`` mesh) shards
the dimension major by its first axis, as JAX does; DTensor's plain
``[Shard(d), Shard(d)]`` would order it by the mesh, so that part becomes
``_StridedShard(d, split_factor=…)`` on the earlier mesh dimension.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..configs.base import ParallelConfig
from ..tree import tree_map


def is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


@dataclass
class Rules:
    mesh: Any                     # Mapping[str, int] or a DeviceMesh
    table: Dict[str, Tuple[str, ...]]
    dropped: List[Tuple[str, str]] = field(default_factory=list)

    @staticmethod
    def make(mesh, par: ParallelConfig) -> "Rules":
        t = {
            "batch": par.batch_axes,
            "seq": par.seq_axes,
            "kv_seq": par.kv_seq_axes,
            "embed_act": (),                 # activations replicated on d_model
            "heads": par.tp_axes,
            "kv_heads": par.tp_axes,
            "mlp_act": par.tp_axes,
            "vocab_act": par.tp_axes,
            "experts": par.tp_axes,
            "wfsdp": par.fsdp_axes,
            "wtp": par.tp_axes,
            # 2D sharding for large OUTPUT dims of weight matmuls (see the
            # reference: sharding a contraction dim forces partial sums of
            # the activations)
            "wtp2": tuple(dict.fromkeys(par.tp_axes + par.fsdp_axes)),
            "norm": (),
            None: (),
        }
        return Rules(mesh, t)

    # ------------------------------------------------------------- mesh
    @property
    def on_mesh(self) -> bool:
        """Whether the rules lay tensors out on a DeviceMesh."""
        return is_device_mesh(self.mesh)

    @property
    def sizes(self) -> Dict[str, int]:
        """The mesh's axis sizes by name."""
        if self.on_mesh:
            return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        return {a: int(n) for a, n in self.mesh.items()}

    def _axes_for(self, name: Optional[str], size: int, used: set
                  ) -> Tuple[str, ...]:
        sizes = self.sizes
        axes = tuple(a for a in self.table.get(name, ()) if a in sizes)
        axes = tuple(a for a in axes if a not in used)
        while axes:
            prod = math.prod(int(sizes[a]) for a in axes)
            if size % prod == 0:
                return axes
            dropped = axes[-1]
            axes = axes[:-1]
            self.dropped.append((str(name), dropped))
        return ()

    def spec(self, shape: Sequence[int], names: Sequence[Optional[str]]
             ) -> Tuple:
        if len(shape) != len(names):
            raise ValueError(f"shape {tuple(shape)} and names {tuple(names)} "
                             f"differ in length")
        used: set = set()
        parts = []
        for size, name in zip(shape, names):
            axes = self._axes_for(name, int(size), used)
            used.update(axes)
            if len(axes) == 0:
                parts.append(None)
            elif len(axes) == 1:
                parts.append(axes[0])
            else:
                parts.append(tuple(axes))
        return tuple(parts)

    # ------------------------------------------------------- placements
    def spec_placements(self, spec: Sequence) -> Tuple:
        """A spec's DTensor placements, one per mesh dimension."""
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.placement_types import _StridedShard

        dims = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(dims)
        for d, part in enumerate(spec):
            # an axis of one device splits nothing: whole on it
            idx = [dims.index(a) for a in _axes(part) if self.sizes[a] > 1]
            if idx == sorted(idx):
                for i in idx:
                    out[i] = Shard(d)
            elif len(idx) == 2:
                # JAX shards major by the first axis named: the later mesh
                # dimension splits the rows first, so the earlier one takes
                # strides of the later one's size
                major, minor = idx
                out[minor] = _StridedShard(
                    d, split_factor=int(self.mesh.shape[major]))
                out[major] = Shard(d)
            else:
                raise NotImplementedError(
                    f"spec part {part} orders three or more mesh axes "
                    f"against the mesh's order {tuple(dims)}")
        return tuple(out)

    def placements(self, shape: Sequence[int],
                   names: Sequence[Optional[str]]) -> Tuple:
        """DTensor placements of a tensor of ``shape`` by logical names."""
        return self.spec_placements(self.spec(shape, names))

    def local_block(self, x, spec: Sequence):
        """This rank's block of a full tensor ``x`` laid out by ``spec``: a
        dimension sharded over axes (a1, a2, …) is cut into their product
        of equal blocks, numbered major by a1, as JAX numbers them."""
        for d, part in enumerate(spec):
            axes = _axes(part)
            if axes:
                n = x.shape[d] // math.prod(self.sizes[a] for a in axes)
                x = x.narrow(d, self.shard_index(axes) * n, n)
        return x

    def distribute(self, x, names: Sequence[Optional[str]]):
        """``x`` laid out by its logical names: the reference's `sharding`
        plus ``device_put``.  Every rank passes the same full tensor and
        keeps its own block (no communication); a DTensor is redistributed;
        on a mapping, ``x`` itself."""
        if not self.on_mesh:
            return x
        return self.distribute_spec(x, self.spec(x.shape, names))

    def distribute_spec(self, x, spec: Sequence, device=None):
        """``x`` laid out by ``spec``; a plain tensor's block is copied to
        ``device`` where given."""
        from torch.distributed.tensor import DTensor
        if is_dtensor(x):
            return x.redistribute(self.mesh, self.spec_placements(spec))
        local = self.local_block(x, spec)
        # a block of its own, so the full tensor is not kept alive by it
        local = local.clone() if local.numel() < x.numel() \
            else local.contiguous()
        if device is not None:
            local = local.to(device)
        return DTensor.from_local(local, self.mesh,
                                  self.spec_placements(spec),
                                  run_check=False, shape=x.shape,
                                  stride=x.contiguous().stride())

    def constrain(self, x, *names: Optional[str]):
        """The reference's ``with_sharding_constraint`` by logical names: a
        DTensor redistributed to its spec.  On a one-device mapping ``x``
        itself.  A plain tensor on a DeviceMesh raises: it is never
        replicated silently."""
        if not self.on_mesh:
            if math.prod(self.sizes.values()) > 1:
                raise ValueError(
                    f"mesh {dict(self.mesh)} is a mapping of axis sizes, "
                    f"which lays no tensor out: give Rules a DeviceMesh")
            return x
        if not is_dtensor(x):
            raise TypeError(
                f"constrain{tuple(names)} got a plain tensor on the device "
                f"mesh {self.sizes}: a tensor of the sharded path is a "
                f"DTensor (Rules.distribute)")
        want = self.placements(x.shape, names)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    def gather_fsdp(self, tree):
        """``tree``'s DTensors with their fsdp axes gathered (replicated),
        their other shards kept: what XLA does with a weight sharded over
        the fsdp axes where it is used (the reference's fsdp).  The
        gradient of a gathered weight is reduce-scattered back to its
        layout.  Elsewhere ``tree`` itself."""
        if not self.on_mesh:
            return tree
        from torch.distributed.tensor import Replicate
        fsdp = set(self.table["wfsdp"])
        dims = self.mesh.mesh_dim_names

        def one(x):
            if not is_dtensor(x):
                return x
            want = tuple(Replicate() if d in fsdp else p
                         for d, p in zip(dims, x.placements))
            if want == tuple(x.placements):
                return x
            return x.redistribute(self.mesh, want)

        return tree_map(one, tree)

    def context(self):
        """The context a step runs in: on a DeviceMesh, plain tensors made
        inside it (positions, masks, a step count, the learning rate) meet
        DTensors as replicated ones; elsewhere nothing."""
        return plain_as_replicated() if self.on_mesh \
            else contextlib.nullcontext()

    def local_map(self, fn, outs: Sequence, ins: Sequence,
                  grads: Optional[Sequence] = None):
        """``fn`` run on each rank's local blocks
        (`torch.distributed.tensor.experimental.local_map`): its DTensor
        arguments redistributed to ``ins`` first (None for an argument that
        is not a tensor), its outputs made DTensors with ``outs`` (one
        placements tuple an output), the arguments' gradients taken with
        ``grads`` where given (a Partial where ranks hold parts of one)."""
        from torch.distributed.tensor.experimental import local_map
        out = (list(outs[0]) if len(outs) == 1 else
               tuple(None if o is None else list(o) for o in outs))

        def lists(pls):
            return None if pls is None else tuple(
                None if p is None else list(p) for p in pls)
        return local_map(fn, out_placements=out, in_placements=lists(ins),
                         in_grad_placements=lists(grads),
                         device_mesh=self.mesh, redistribute_inputs=True)

    def shard_index(self, axes: Sequence[str]) -> int:
        """This rank's block index along a dimension sharded over ``axes``,
        major by the first (JAX's numbering)."""
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        index = 0
        for a in axes:
            index = index * self.sizes[a] + coord[a]
        return index


@contextlib.contextmanager
def plain_as_replicated():
    """`torch.distributed.tensor.experimental.implicit_replication`, but
    nestable: the previous setting is restored on exit, not cleared."""
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def global_offset(shape, mesh, placements) -> Tuple[int, ...]:
    """The global index of the first element of this rank's block of a
    tensor of ``shape`` laid out by ``placements``, per dimension."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    return tuple(compute_local_shape_and_global_offset(
        tuple(shape), mesh, tuple(placements))[1])


def unshard(placements, dims: Sequence[int]) -> Tuple:
    """``placements`` with every shard of the tensor dimensions ``dims``
    replicated."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if any(p.is_shard(d) for d in dims) else p
                 for p in placements)


def drop_leading(placements, k: int) -> Tuple:
    """The placements of ``x[i_1, …, i_k]`` given those of ``x``, whose
    first k dimensions must be whole on every rank."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    out = []
    for p in placements:
        if isinstance(p, Shard):
            if p.dim < k:
                raise ValueError(f"{p} shards a dimension that is indexed")
            out.append(_StridedShard(p.dim - k, split_factor=p.split_factor)
                       if isinstance(p, _StridedShard) else Shard(p.dim - k))
        else:
            out.append(p)
    return tuple(out)


def local_tensor(x):
    """The storage of a DTensor's local block (written in place by the
    cache updates); a plain tensor itself."""
    return x._local_tensor if is_dtensor(x) else x


def set_index(leaf, index: Tuple[int, ...], val) -> None:
    """``leaf[index] = val`` in place, for a DTensor whose indexed leading
    dimensions are whole on every rank: each rank writes its own block."""
    pl = drop_leading(leaf.placements, len(index))
    val = val.to(leaf.dtype)
    if is_dtensor(val):
        val = val.redistribute(leaf.device_mesh, pl).to_local()
    local_tensor(leaf)[index] = val


def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(i, (int, str, type(None))) for i in x)


def spec_tree(rules: Rules, shapes, names):
    """Map a tree (nested dicts) of shapes + a matching tree of logical-name
    tuples to specs."""
    if _is_names(shapes):
        return rules.spec(shapes, names)
    return {k: spec_tree(rules, shapes[k], names[k]) for k in shapes}
