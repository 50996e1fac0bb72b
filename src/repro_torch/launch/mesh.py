"""Production mesh builders, as the axis sizes the port's `Rules` takes.

The counterpart of `repro.launch.mesh`.  The port has no named device mesh
(`repro_torch.models.sharding`): a mesh is a mapping of axis names to
sizes, so every arch's `ParallelConfig` and every `Rules` fallback carry
over unchanged.  Single-pod: 16×16, 256 cards; multi-pod: 2×16×16, 512
cards, the "pod" axis crossing the data-center network.  These meshes are
what the dry run (`repro_torch.launch.dryrun`) lays each step out on; no
code of the port runs a model across them (see the dry run's docstring).
`make_host_mesh(1, 1)` is the one card.

The module holds no rates of its own: the roofline's are the card's, from
`repro_torch.device` (the counterpart of the reference's v5e constants),
re-exported here as the reference's module exports its own.
"""
from __future__ import annotations

from typing import Dict

from ..device import HBM_BW, PEAK_FLOPS_BF16  # noqa: F401  (re-exported)


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(data: int = 2, model: int = 2) -> Dict[str, int]:
    """A small mesh, for tests and examples; (1, 1) is the one card."""
    return {"data": data, "model": model}
