"""Collective primitives behind the ``"torch"`` lowering backend.

These are the raw transfers `repro_torch.runtime.torch_backend` registers
against the lowering vocabulary (which lowering uses which primitive is the
registry's business, not encoded here).  Each works on a stage group
(`repro_torch.comm.group`), the counterpart of the reference's mesh axis:

* `fifo_shift` — one hop to the next stage.  Cheap: a single neighbour
  transfer (one ``batch_isend_irecv`` on a `DistGroup`, a roll of the stage
  dimension on a `LocalGroup`).
* `reorder_buffer_read` — every stage's value is all-gathered and the
  consumer indexes what it needs.  This is the expensive transfer the
  paper's algorithm exists to avoid; it is implemented (and measured) as the
  baseline.

Both are differentiable on either group.  `ring_hop` and `ring_gather` are
the rotating ring's per-tick steps built from them: the ``step`` hook of
every lowering that serves the pipeline, whichever backend registers it.
"""
from __future__ import annotations

import torch


def fifo_shift(x: torch.Tensor, group, shift: int = 1,
               wrap: bool = False) -> torch.Tensor:
    """Send x to the stage ``shift`` further along ``group`` (FIFO
    neighbour stream); without ``wrap`` the first stages receive zeros."""
    return group.shift(x, shift, wrap)


def reorder_buffer_read(x: torch.Tensor, group,
                        index: torch.Tensor) -> torch.Tensor:
    """Out-of-order channel: publish everyone's value (all-gather), and let
    each local stage read the producer's slot ``index`` (a long tensor, one
    entry per local stage)."""
    buf = group.all_gather(x)                  # (b, n, …) addressable buffer
    return buf[torch.arange(buf.shape[0], device=buf.device), index]


def ring_hop(h: torch.Tensor, group, stage: torch.Tensor,
             n: int) -> torch.Tensor:
    """One tick of the ring over a FIFO stream: stage s hands its value to
    stage s+1, the last wrapping round to the first."""
    return fifo_shift(h, group, 1, wrap=True)


def ring_gather(h: torch.Tensor, group, stage: torch.Tensor,
                n: int) -> torch.Tensor:
    """One tick of the ring through the reorder buffer: every stage reads
    its producer's slot, stage s-1's, from the all-gathered values."""
    return reorder_buffer_read(h, group, (stage - 1) % n)
