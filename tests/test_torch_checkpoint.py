"""The port's checkpoint manager (`repro_torch.checkpoint`) against the JAX
package's.

1. Every case of ``tests/test_checkpoint.py`` on the port: the atomic
   round trip, the GC of all but the last k, the refusal of a missing
   step, the elastic restore (here onto another device than the one the
   like-tree names: ``meta`` tensors restored onto the CPU), the async
   save; and the checkpoint case of ``tests/test_resilience.py`` (the
   orphan sweep and the refusal of an unpublished ``.tmp`` step).
2. Checkpoints across the two packages, both ways, bit for bit: a tree of
   float32, bf16, int8 and 0-d int32 leaves, and a reduced model's whole
   train state (bf16 parameters, float32 and int8 moments).  The reference
   flattens dicts in sorted key order and the port in insertion order, so
   the trees are built in an unsorted order: a restore matches by key.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.tree import tree_items, tree_leaves, tree_map  # noqa: E402


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": torch.zeros(())}}


def _bits(x) -> np.ndarray:
    """A leaf's bytes as uint8, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().reshape(-1).view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


# ------------------------------------------------- tests/test_checkpoint.py

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree()
    mgr.save(3, t, extra={"data_step": 7}, blocking=True)
    like = tree_map(torch.zeros_like, t)
    got, extra = mgr.restore(None, like)
    assert extra["data_step"] == 7
    for a, b in zip(tree_leaves(t), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree(), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(None, tree())


def test_elastic_restore_onto_another_device(tmp_path):
    """Checkpoints store logical arrays: a like-tree that holds no data
    (``meta`` tensors, as the trainer's abstract state) restores onto the
    device asked for, values exact."""
    mgr = CheckpointManager(str(tmp_path))
    t = {"w": torch.arange(16.0).reshape(4, 4)}
    mgr.save(1, t, blocking=True)
    like = {"w": torch.empty((4, 4), device="meta")}
    got, _ = mgr.restore(1, like, device="cpu")
    assert got["w"].device.type == "cpu"
    assert torch.equal(got["w"], t["w"])
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(1, {"v": torch.zeros(2)})


def test_async_save_overlaps(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree())            # returns before write completes
    mgr.wait()
    assert mgr.latest_step() == 1


def test_save_snapshots_before_returning(tmp_path):
    """The host copy is taken on the caller's thread: an in-place update
    right after `save` returns does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    t = {"w": torch.ones(1000)}
    mgr.save(1, t)
    t["w"].mul_(3.0)
    mgr.wait()
    got, _ = mgr.restore(1, t)
    assert torch.equal(got["w"], torch.ones(1000))


# -------------------------------- tests/test_resilience.py (checkpoint case)

def test_checkpoint_sweeps_orphans_and_refuses_tmp_restore(tmp_path):
    orphan = tmp_path / "step_000000007.tmp"
    orphan.mkdir()
    (orphan / "meta.json").write_text("{}")
    mgr = CheckpointManager(tmp_path)
    assert mgr.swept == ["step_000000007.tmp"]
    assert not orphan.exists()
    # a fresh unpublished save must be refused, with a telling error
    half = tmp_path / "step_000000009.tmp"
    half.mkdir()
    with pytest.raises(FileNotFoundError, match="never completed"):
        mgr.restore(9, {"w": torch.zeros(2)})
    assert mgr.all_steps() == []          # .tmp is not a restorable step


# ------------------------------------------------------ across the packages

def _mixed_numpy():
    """Leaves of every dtype a train state holds, keys in no sorted order."""
    rng = np.random.default_rng(3)
    return {"z": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                  "bf": rng.standard_normal((2, 7)).astype(jnp.bfloat16)},
            "opt": {"m": {"q": rng.integers(-127, 128, (4, 300))
                          .astype(np.int8),
                          "scale": rng.random((4, 2)).astype(np.float32)},
                    "step": np.array(5, np.int32)},
            "a": rng.standard_normal((6,)).astype(jnp.bfloat16)}


def _port_tree(tree):
    from repro_torch.models.common import params_from_numpy
    return params_from_numpy(tree, "cpu")


def _assert_same(ref_tree, port_tree):
    ref = dict(tree_items(ref_tree))
    got = dict(tree_items(port_tree))
    assert set(ref) == set(got)
    for k in ref:
        assert tuple(np.shape(ref[k])) == tuple(got[k].shape), k
        np.testing.assert_array_equal(_bits(ref[k]), _bits(got[k]),
                                      err_msg=k)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    src = _mixed_numpy()
    RefManager(str(tmp_path)).save(4, jax.tree.map(jnp.asarray, src),
                                   extra={"data_step": 9}, blocking=True)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), _port_tree(src))
    got, extra = CheckpointManager(str(tmp_path)).restore(None, like, "cpu")
    assert extra == {"data_step": 9}
    assert got["z"]["bf"].dtype == torch.bfloat16
    assert got["opt"]["m"]["q"].dtype == torch.int8
    _assert_same(src, got)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    src = _mixed_numpy()
    CheckpointManager(str(tmp_path)).save(6, _port_tree(src),
                                          extra={"data_step": 6},
                                          blocking=True)
    meta = json.loads((tmp_path / "step_000000006" / "meta.json")
                      .read_text())
    assert meta["keys"][0] == "['z']['w']"       # insertion order, keystr
    like = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), src)
    got, extra = RefManager(str(tmp_path)).restore(6, like)
    assert extra == {"data_step": 6}
    assert got["a"].dtype == jnp.bfloat16
    _assert_same(jax.tree.map(np.asarray, got), _port_tree(src))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_train_state_checkpoints_cross_both_ways(tmp_path, state_dtype):
    """A reduced model's whole train state (bf16 parameters, moments in
    ``state_dtype``), saved by one package and restored by the other, bit
    for bit."""
    from repro.optim import adamw_init as jadamw_init
    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.models import build
    from repro_torch.train.step import (init_train_state,
                                        make_abstract_train_state)

    arch = "smollm-135m"
    par = configs.get(arch).parallel_for("train_4k", False).replace(
        optimizer_state_dtype=state_dtype)
    model = build(reduced(configs.get(arch).model), par)
    state = init_train_state(model, 2, "cpu")
    # the reference's train state (its `init_train_state` structure) on the
    # same bf16 parameters
    jparams = jax.tree.map(jnp.asarray, tree_map(
        lambda t: t.view(torch.int16).numpy().view(jnp.bfloat16),
        state["params"]))
    jstate = {"params": jparams, "opt": jadamw_init(jparams, state_dtype)}
    RefManager(str(tmp_path / "ref")).save(1, jstate, blocking=True)
    got, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        1, make_abstract_train_state(model), "cpu")
    _assert_same(jax.tree.map(np.asarray, jstate), got)

    CheckpointManager(str(tmp_path / "port")).save(1, state, blocking=True)
    back, _ = RefManager(str(tmp_path / "port")).restore(1, jstate)
    _assert_same(jax.tree.map(np.asarray, back), state)
