"""Production mesh builders, and the device mesh a sharded step runs on.

The counterpart of `repro.launch.mesh`.  `make_production_mesh` and
`make_host_mesh` return a mesh as its axis sizes, a mapping of axis names
to sizes, which `Rules` takes as it takes a mesh.  Single-pod: 16×16, 256
cards; multi-pod: 2×16×16, 512 cards, the "pod" axis crossing the
data-center network.  `make_host_mesh(1, 1)` is the one card.
`device_mesh` turns such sizes into the
`torch.distributed.device_mesh.DeviceMesh` over the default process group
that the sharded train step and server run on (`Rules` given a DeviceMesh
lays every tensor out as a DTensor), and `init_from_env` starts that group
from the environment as ``jax.distributed.initialize`` does.
`fake_device_mesh` is the same DeviceMesh as device 0 of a mesh of any
size sees it, in one process and without cards: the dry run
(`repro_torch.launch.dryrun`) runs each step on it on ``meta``.

The module holds no rates of its own: the roofline's are the card's, from
`repro_torch.device` (the counterpart of the reference's v5e constants),
re-exported here as the reference's module exports its own (``LINK_BW``
for its ``ICI_BW``).
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, Iterator, Mapping

from ..device import (HBM_BW, LINK_BW,  # noqa: F401  (re-exported)
                      PEAK_FLOPS_BF16)


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(data: int = 2, model: int = 2) -> Dict[str, int]:
    """A small mesh, for tests and examples; (1, 1) is the one card."""
    return {"data": data, "model": model}


def device_mesh(sizes: Mapping[str, int], device="cuda"):
    """The DeviceMesh of axis ``sizes`` (in their order) over the default
    process group, whose world size must be their product, on ``device``'s
    type (a card a rank, or the CPU under gloo)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type,
                            tuple(int(n) for n in sizes.values()),
                            mesh_dim_names=tuple(sizes))


def init_from_env(sizes: Mapping[str, int], device="cuda") -> None:
    """Join the job the environment names (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; rank r on card ``LOCAL_RANK``),
    NCCL on the card and gloo on the CPU, unless the default group is up;
    then refuse a world size other than the mesh's card count."""
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    world, need = dist.get_world_size(), math.prod(sizes.values())
    if world != need:
        raise ValueError(f"a world of {world} ranks does not match the mesh "
                         f"{dict(sizes)} of {need} cards")


@contextlib.contextmanager
def fake_device_mesh(sizes: Mapping[str, int]) -> Iterator:
    """The DeviceMesh of axis ``sizes`` (in their order) as its device 0
    sees it, over a default process group on PyTorch's in-process
    ``"fake"`` backend of world size ``prod(sizes)``: its collectives
    return at once and move nothing, so a step on ``meta`` tensors runs as
    rank 0's program (what the dry run counts).  The mesh's device type is
    the card's, ``cuda``, with or without a card: DTensor then plans each
    redistribute as on the cards, where on a CPU mesh it would turn an
    all-to-all into an all-gather and a chunk (gloo has no all-to-all).
    The group is taken down on exit, on an
    exception too; a default group already up raises (it is never
    reused: the launchers and tests decide things from
    ``dist.is_initialized()``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_device_mesh: a default process group is "
                           "already up; a fake mesh starts its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(int(n)
                                                 for n in sizes.values()))
    try:
        yield device_mesh(sizes, "cuda")
    finally:
        dist.destroy_process_group()
