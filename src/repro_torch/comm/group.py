"""Stage groups: the port's counterpart of a named mesh axis inside
``shard_map``.

The reference runs the pipeline ring inside ``shard_map`` over a ``pipe``
mesh axis: each device holds one stage, ``lax.axis_index`` names it and
``ppermute`` / ``all_gather`` / ``psum`` move values along the axis.  Torch
has no such axis, so a *stage group* stands in for it.  Every tensor that
crosses a group carries the block of stages held locally as its leading
dimension, and the group offers the four moves the ring needs:

* ``size`` — the number of stages (the axis size);
* ``stages`` — a long tensor of the stage indices held locally, the
  counterpart of ``lax.axis_index``;
* ``device`` — where the local block lives;
* ``shift(x, k, wrap)`` — stage s receives stage (s − k)'s value; without
  ``wrap`` a stage with no sender receives zeros, as ``lax.ppermute`` gives;
* ``all_gather(x)`` — every stage receives the whole axis, ``(b, size, …)``;
* ``all_reduce(x, op)`` — op ``"sum"`` or ``"max"`` over the axis, the
  result on every stage.

Two implementations:

* `LocalGroup` holds all n stages in one process on one device, the stage
  being dimension 0; its moves are torch ops, and autograd differentiates
  them.
* `DistGroup` is one `torch.distributed` rank per stage (block size 1): gloo
  on CPU tensors, NCCL on ``cuda:rank``.  Its moves are
  `torch.autograd.Function`s whose backward is the transposed collective: a
  shift's is the reverse shift, the all-gather's a sum-scatter of the
  cotangent, and the sum all-reduce's the identity.  The identity is
  deliberate: every rank seeds its own copy of the replicated loss, so an
  all-reduce in backward (as ``torch.distributed.nn.functional.all_reduce``
  has) would multiply every gradient by n.  ``"max"`` carries no gradient.

`run_ranks` spawns one process per rank, joins a process group in each and
bounds the whole run by a timeout.
"""
from __future__ import annotations

import socket
import time
from datetime import timedelta
from typing import Callable, Sequence

import torch
import torch.distributed as dist

REDUCE_OPS = ("sum", "max")

#: how long a rank waits on a rendezvous or a collective before it fails
COLLECTIVE_TIMEOUT = timedelta(seconds=60)

# the single-tensor collectives: named *_single since torch 2.13, where the
# older names warn that they are deprecated
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def _check_op(op: str) -> None:
    if op not in REDUCE_OPS:
        raise ValueError(f"all_reduce op must be one of {REDUCE_OPS}, "
                         f"not {op!r}")


class LocalGroup:
    """All ``n`` stages in one process: dimension 0 of every tensor is the
    stage.  ``device=None`` means the card (``"cuda"``)."""

    def __init__(self, n: int, device=None):
        if n < 1:
            raise ValueError(f"a group needs at least one stage, not {n}")
        self.size = n
        self.device = torch.device("cuda" if device is None else device)
        self.stages = torch.arange(n, device=self.device)

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[:1] != (self.size,):
            raise ValueError(f"leading dimension {tuple(x.shape[:1])} is not "
                             f"the group's {self.size} stages")

    def shift(self, x: torch.Tensor, k: int = 1,
              wrap: bool = False) -> torch.Tensor:
        self._check(x)
        if wrap:
            return torch.roll(x, k, 0)
        if abs(k) >= self.size:
            return torch.zeros_like(x)
        zeros = x.new_zeros((abs(k),) + x.shape[1:])
        if k >= 0:
            return torch.cat([zeros, x[:self.size - k]])
        return torch.cat([x[-k:], zeros])

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.unsqueeze(0).expand((self.size,) + x.shape)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        self._check(x)
        _check_op(op)
        red = (x.sum(0, keepdim=True) if op == "sum"
               else x.amax(0, keepdim=True))
        return red.expand_as(x)


# ------------------------------------------------------- torch.distributed --

def _shift_raw(x: torch.Tensor, k: int, wrap: bool, pg) -> torch.Tensor:
    n, rank = dist.get_world_size(pg), dist.get_rank(pg)
    if wrap and k % n == 0:
        return x.clone()
    x = x.contiguous()
    out = torch.zeros_like(x)
    dst, src = rank + k, rank - k
    if wrap:
        dst, src = dst % n, src % n

    def peer(r: int) -> int:
        return r if pg is None else dist.get_global_rank(pg, r)

    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, x, peer(dst), pg))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, out, peer(src), pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, wrap, pg):
        ctx.k, ctx.wrap, ctx.pg = k, wrap, pg
        return _shift_raw(x, k, wrap, pg)

    @staticmethod
    def backward(ctx, g):
        return _shift_raw(g, -ctx.k, ctx.wrap, ctx.pg), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        n = dist.get_world_size(pg)
        out = x.new_empty((n,) + x.shape[1:])
        _all_gather_single(out, x.contiguous(), group=pg)
        return out.unsqueeze(0)

    @staticmethod
    def backward(ctx, g):
        g = g[0].contiguous()
        out = g.new_empty((1,) + g.shape[1:])
        _reduce_scatter_single(out, g, op=dist.ReduceOp.SUM, group=ctx.pg)
        return out, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=pg)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class DistGroup:
    """One `torch.distributed` rank per stage; every tensor's leading
    dimension is 1, this rank's stage.  ``process_group=None`` means the
    default group.  The device follows the group's backend: the CPU under
    gloo, ``cuda:<current device>`` under NCCL (one card per rank)."""

    def __init__(self, process_group=None):
        if not dist.is_initialized():
            raise RuntimeError("DistGroup needs torch.distributed "
                               "initialised (init_process_group)")
        self.pg = process_group
        self.size = dist.get_world_size(process_group)
        self.rank = dist.get_rank(process_group)
        if dist.get_backend(process_group) == "nccl":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu")
        self.stages = torch.tensor([self.rank], device=self.device)

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[:1] != (1,):
            raise ValueError(f"leading dimension {tuple(x.shape[:1])} is not "
                             f"one rank's block of 1 stage")

    def shift(self, x: torch.Tensor, k: int = 1,
              wrap: bool = False) -> torch.Tensor:
        self._check(x)
        return _Shift.apply(x, k, wrap, self.pg)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return _AllGather.apply(x, self.pg)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        self._check(x)
        _check_op(op)
        if op == "sum":
            return _AllReduceSum.apply(x, self.pg)
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.pg)
        return out


# ------------------------------------------------------------------ ranks --

def _free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, init_method: str,
               backend: str, args: Sequence) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              backend: str = "gloo", timeout: float = 120.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes, each in a
    process group of ``backend`` (``"gloo"``, or ``"nccl"`` with rank r on
    card r) that meets at a free port on localhost.  ``fn`` must be
    importable by name (a module-level function).  Raises if a rank raises,
    and kills every rank and raises `TimeoutError` if they have not all
    ended within ``timeout`` seconds."""
    import torch.multiprocessing as mp

    init = f"tcp://localhost:{_free_port()}"
    ctx = mp.start_processes(_rank_main,
                             args=(fn, world, init, backend, tuple(args)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} {backend} ranks did not end "
                                   f"within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
