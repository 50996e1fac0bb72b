"""The ``"torch"`` backend: collective implementations of the lowering IR.

Each `ChannelLowering` here builds the per-tick communication step of the
rotating pipeline ring (`comm/pipeline.py`) from the primitives in
`comm/channels.py`, on a stage group (`comm/group.py`):

* every ppermute-family lowering is one neighbour-stream hop — the recovered
  split variants and the broadcast register all ride the same cheap link
  (the register is consumer-local: the received value is simply reused
  across ticks);
* the reorder buffer publishes every stage's value (an all-gather) and
  indexes the producer's slot — the expensive lowering the paper's
  algorithm exists to avoid, kept as the measured baseline.

The counterpart of the reference's ``"jax"`` backend; loaded lazily by the
registry (`backend("torch")`).
"""
from __future__ import annotations

from ..comm.channels import ring_gather, ring_hop
from .lowering import (BROADCAST_REGISTER, CHUNK_SPLIT, DEPTH_SPLIT,
                       FIFO_STREAM, REORDER_BUFFER, ChannelLowering,
                       register_backend)

TORCH = register_backend("torch")


@TORCH.register(FIFO_STREAM, DEPTH_SPLIT, CHUNK_SPLIT, BROADCAST_REGISTER)
class PpermuteRing(ChannelLowering):
    """FIFO neighbour stream: one hop per tick."""

    step = staticmethod(ring_hop)


@TORCH.register(REORDER_BUFFER)
class ReorderBufferRing(ChannelLowering):
    """Out-of-order fallback: all-gather + index of the producer."""

    step = staticmethod(ring_gather)
