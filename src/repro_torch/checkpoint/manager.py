"""Atomic, async checkpointing with restore onto any device.

The port of `repro.checkpoint.manager`, with the same layout (one directory
per step):

    <root>/step_000123.tmp/          — written first
        meta.json                    — step, leaf keys, shapes, dtypes
        arrays.npz                   — logical (whole) arrays
    <root>/step_000123/              — atomic rename when complete

Each leaf's key is its path spelt as ``jax.tree_util.keystr`` spells it
(``['params']['embed']``), and a restore matches leaves by key, never by
position: the reference flattens dicts in sorted key order and the port in
insertion order, and either package restores the other's checkpoints.  bf16
leaves are stored as raw bytes (npz has no bf16), their true dtype and shape
in ``meta.json``.  The reference restores onto a new mesh through
``shardings``; the port restores onto a ``device``, or, given ``mesh`` and
a tree of DTensor ``placements``, onto that mesh: each rank reads the whole
arrays and keeps its blocks, so a checkpoint saved on one mesh restores on
any other (another shape, or one device).

A tree of DTensors (the sharded train state) is saved whole: every rank
joins the gathers of its leaves (``full_tensor``), rank 0 alone writes, and
the other ranks wait on a barrier until the write is published, in `wait`.

Saves run on a background thread (async checkpointing): `save` copies every
leaf to host memory on the caller's thread, with a synchronous copy, before
it returns, so the caller may update its tensors in place at once.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.sharding import is_dtensor
from ..tree import tree_items, tree_leaves, tree_map_with_path

#: torch dtype → the numpy dtype name the reference writes into meta.json
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (a tensor copied off its device
    now, synchronously); bf16 as its raw bytes."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint8).reshape(-1)
        return t.numpy()
    return np.array(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _NAMES[leaf.dtype]
    return str(np.asarray(leaf).dtype)


def _tensor(arr: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    """The saved array as a tensor of its true dtype and shape."""
    if dtype_name == "bfloat16":
        bits = np.frombuffer(arr.tobytes(), np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if arr.dtype == np.uint8 and dtype_name != "uint8":
        arr = np.frombuffer(arr.tobytes(), np.dtype(dtype_name))
    return torch.from_numpy(np.array(arr).reshape(shape))


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False           # ranks of a mesh save to meet
        self.swept = self._sweep_orphans()

    def _sweep_orphans(self) -> List[str]:
        """Delete ``step_*.tmp`` directories left by a save that died before
        its atomic publish — they hold partial data and must never be
        restored from or allowed to shadow a later save of the same step."""
        orphans = sorted(p.name for p in self.root.glob("step_*.tmp"))
        for name in orphans:
            shutil.rmtree(self.root / name, ignore_errors=True)
        return orphans

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot to host, then write asynchronously."""
        self.wait()                     # one outstanding save at a time
        flat = [(k, _host(leaf), _dtype_name(leaf), list(np.shape(leaf)))
                for k, leaf in tree_items(tree)]
        if any(is_dtensor(leaf) for leaf in tree_leaves(tree)):
            import torch.distributed as dist
            self._barrier = True
            if dist.get_rank() != 0:
                if blocking:
                    self.wait()
                return

        def _write():
            try:
                tmp = self.root / f"step_{step:09d}.tmp"
                final = self.root / f"step_{step:09d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "arrays.npz",
                         **{f"a{i}": a for i, (_, a, _, _) in enumerate(flat)})
                meta = {
                    "step": step,
                    "time": time.time(),
                    "keys": [k for k, _, _, _ in flat],
                    "shapes": [shape for _, _, _, shape in flat],
                    "dtypes": [name for _, _, name, _ in flat],
                    "extra": extra or {},
                }
                (tmp / "meta.json").write_text(json.dumps(meta))
                os.replace(tmp, final)          # atomic publish
                self._gc()
            except BaseException as e:          # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.root.glob("step_*")
                      if not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like_tree, device=None,
                mesh=None, placements=None) -> Tuple[Any, Dict]:
        """Restore into the structure of `like_tree` (tensors of any device,
        ``meta`` ones included, or arrays: only its keys are read), each
        leaf in its saved dtype, on ``device``, or where None on the device
        of the matching leaf of `like_tree` (the CPU for a non-tensor).
        Given a DeviceMesh ``mesh`` and ``placements`` (a tree like
        `like_tree` of DTensor placements), each leaf becomes a DTensor laid
        out by its placements on ``mesh``, on ``device``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:09d}"
        if not d.exists():
            tmp = self.root / f"step_{step:09d}.tmp"
            if tmp.exists():
                raise FileNotFoundError(
                    f"step {step} only exists as unpublished {tmp.name} — "
                    f"the save never completed; refusing to restore "
                    f"partial data")
            raise FileNotFoundError(f"no checkpoint for step {step} "
                                    f"under {self.root}")
        meta = json.loads((d / "meta.json").read_text())
        keys = {k: i for i, k in enumerate(meta["keys"])}
        pl = dict(tree_items(placements)) if placements is not None else {}
        with np.load(d / "arrays.npz") as data:
            def one(path, ref):
                if path not in keys:
                    raise KeyError(f"checkpoint missing leaf {path}")
                i = keys[path]
                t = _tensor(data[f"a{i}"], meta["dtypes"][i],
                            tuple(meta["shapes"][i]))
                where = device if device is not None else (
                    ref.device if isinstance(ref, torch.Tensor) else "cpu")
                if mesh is not None:
                    from torch.distributed.tensor import distribute_tensor
                    return distribute_tensor(t.to(where), mesh, pl[path],
                                             src_data_rank=None)
                return t.to(where)

            out = tree_map_with_path(one, like_tree)
        return out, meta.get("extra", {})

