"""Logical-axis sharding rules with divisibility fallback.

The port of `repro.models.sharding`.  Tensors are annotated with *logical*
axis names; a `Rules` object (derived from the arch's ParallelConfig + the
mesh) maps them to mesh axes.  When a dimension does not divide the mapped
mesh axes' product (e.g. smollm's 9 heads on a 16-way model axis), axes are
dropped from the right until it does — the fallback is recorded in
``dropped``, so a report can say where TP degenerated.

Torch has no named device mesh, so the mesh is given by its axis sizes, a
mapping such as ``{"data": 1, "model": 1}``, and `Rules.spec` returns a
tuple with one part per dimension (None, an axis name or a tuple of names)
where the reference returns a ``PartitionSpec``.  The port runs a model on
one device: `Rules.constrain` returns its input there, and refuses a mesh of
more than one device, whose layouts no code of the port carries out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..configs.base import ParallelConfig


@dataclass
class Rules:
    mesh: Mapping[str, int]
    table: Dict[str, Tuple[str, ...]]
    dropped: List[Tuple[str, str]] = field(default_factory=list)

    @staticmethod
    def make(mesh: Mapping[str, int], par: ParallelConfig) -> "Rules":
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

    def _axes_for(self, name: Optional[str], size: int, used: set
                  ) -> Tuple[str, ...]:
        sizes = self.mesh
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

    def constrain(self, x, *names: Optional[str]):
        """The reference's ``with_sharding_constraint`` by logical names: on
        one device there is no layout to constrain, so ``x`` itself."""
        if math.prod(int(s) for s in self.mesh.values()) > 1:
            raise NotImplementedError(
                f"the port runs a model on one device; mesh {dict(self.mesh)}"
                f" asks for sharded activations")
        return x


def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(i, (int, str, type(None))) for i in x)


def spec_tree(rules: Rules, shapes, names):
    """Map a tree (nested dicts) of shapes + a matching tree of logical-name
    tuples to specs."""
    if _is_names(shapes):
        return rules.spec(shapes, names)
    return {k: spec_tree(rules, shapes[k], names[k]) for k in shapes}
