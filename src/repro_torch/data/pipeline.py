"""Deterministic, resumable data pipeline, on one device or a device mesh.

The port of `repro.data.pipeline`.  Synthetic token streams are generated
statelessly from (seed, step, position) via a splitmix-style integer hash,
so any step can be regenerated after a restart — the pipeline state IS the
step counter (plus the seed), which the checkpoint manager persists.  The
tokens are bit-identical to the reference's (the same numpy hash).

A file-backed source (memory-mapped token file) is provided for real data.
A background prefetch thread overlaps host generation with device compute.
The reference places each batch on its mesh with a `PartitionSpec`; the port
copies it to one device (``torch.Tensor.to``, from a fresh host array every
step, so no host buffer is reused while a copy may still read it), or,
given rules on a DeviceMesh, lays it out by ``("batch", "seq")`` (the
reference's ``batch_spec``; other features with their trailing dimensions
whole): every rank makes the same global batch from the same seeds and
copies only its own block to its device, which becomes its shard of a
DTensor (``DTensor.from_local``).

Setting ``step`` (as the trainer's crash replay does) rewinds the stream:
batches the thread queued for the old position are dropped, so the next
batch is the one of the new step.  The reference's queue would still hand
out the batches it prefetched.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + _GOLDEN).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def synthetic_tokens(seed: int, step: int, batch: int, seq: int,
                     vocab: int) -> np.ndarray:
    """(batch, seq) int32 tokens, pure function of (seed, step, index)."""
    base = np.uint64(seed) * np.uint64(1_000_003) + np.uint64(step)
    idx = np.arange(batch * seq, dtype=np.uint64) + base * np.uint64(batch * seq)
    return (_splitmix64(idx) % np.uint64(vocab)).astype(np.int32).reshape(batch, seq)


@dataclass
class FileSource:
    """Memory-mapped flat token file (int32)."""
    path: str
    vocab: int

    def __post_init__(self):
        self._tokens = np.memmap(self.path, dtype=np.int32, mode="r")

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        need = batch * seq
        start = (step * need) % max(len(self._tokens) - need, 1)
        return np.array(self._tokens[start:start + need]).reshape(batch, seq)


class DataPipeline:
    """Iterator of batches on ``device`` with prefetch + exact resume."""

    def __init__(self, device, *, batch: int, seq: int, vocab: int,
                 seed: int = 0, start_step: int = 0,
                 source: Optional[FileSource] = None, prefetch: int = 2,
                 extra: Optional[Dict] = None, rules=None):
        self.device = torch.device(device)
        self.rules = rules if rules is not None and rules.on_mesh else None
        if self.rules is not None:
            self.spec = self.rules.spec((batch, seq), ("batch", "seq"))
        self.batch, self.seq, self.vocab, self.seed = batch, seq, vocab, seed
        self.source = source
        self.extra = extra or {}
        # the consumer's position, the worker's next step to generate, and
        # an epoch that tells queued batches of an older position apart
        self._lock = threading.Lock()
        self._step = self._produce = start_step
        self._epoch = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- position -----------------------------------------------------------
    @property
    def step(self) -> int:
        """The step of the next batch."""
        return self._step

    @step.setter
    def step(self, value: int) -> None:
        with self._lock:
            self._step = self._produce = int(value)
            self._epoch += 1

    # -- state for checkpointing ------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    # -- generation ---------------------------------------------------------
    def _host_batch(self, step: int) -> Dict[str, np.ndarray]:
        if self.source is not None:
            toks = self.source.batch(step, self.batch, self.seq)
        else:
            toks = synthetic_tokens(self.seed, step, self.batch, self.seq,
                                    self.vocab)
        out = {"tokens": toks}
        for k, shape_dtype in self.extra.items():
            shape, dtype = shape_dtype
            idx = np.arange(int(np.prod(shape)), dtype=np.uint64) \
                + np.uint64(step + 7777)
            vals = (_splitmix64(idx) % np.uint64(1000)).astype(np.float32)
            out[k] = ((vals / 500.0) - 1.0).astype(dtype).reshape(shape)
        return out

    def _worker(self):
        item = None
        try:
            while not self._stop.is_set():
                if item is None:
                    with self._lock:
                        epoch, step = self._epoch, self._produce
                        self._produce += 1
                    item = (epoch, step, self._host_batch(step))
                try:
                    self._q.put(item, timeout=0.5)
                    item = None
                except queue.Full:
                    continue
        except Exception as e:             # surfaced by the next __next__
            self._q.put((None, None, e))

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        while True:
            epoch, step, host = self._q.get()
            if epoch is None:
                raise RuntimeError("data pipeline worker failed") from host
            with self._lock:
                if epoch == self._epoch:
                    self._step = step + 1
                    break
        if self.rules is not None:
            return {k: self.rules.distribute_spec(
                torch.from_numpy(v), (self.spec + (None,) * v.ndim)[:v.ndim],
                self.device) for k, v in host.items()}
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in host.items()}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
