"""The port's continuous batching scheduler (`repro_torch.serve.batching`)
against the JAX package's, case for case with ``tests/test_batching.py``:
admission, retirement and utilization, with the same deterministic model
callables in both packages and every generated token compared exactly."""
import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

REF = importlib.import_module("repro.serve.batching")
PORT = importlib.import_module("repro_torch.serve.batching")


def make_batcher(B, capacity=4, max_seq=64):
    slots = B.BatchSlots(capacity=capacity, max_seq=max_seq)

    def prefill_fn(slot, prompt):
        return int(prompt[-1]) + 1          # echo-ish deterministic model

    def step_fn(tokens, pos):
        return (tokens[:, 0] + 1) % 1000

    return B.ContinuousBatcher(slots, prefill_fn, step_fn)


def _done(done):
    return [(r.rid, list(r.generated)) for r in done]


def both(body):
    want, got = body(REF), body(PORT)
    assert got == want
    return got


def test_single_request():
    def body(B):
        b = make_batcher(B)
        b.submit(B.Request(0, np.array([5, 6, 7], np.int32),
                           max_new_tokens=4))
        done = b.run_until_drained()
        assert len(done) == 1
        assert done[0].generated == [8, 9, 10, 11]
        return _done(done), b.slot_steps
    both(body)


def test_more_requests_than_slots():
    def body(B):
        b = make_batcher(B, capacity=2)
        for r in range(5):
            b.submit(B.Request(r, np.array([r], np.int32), max_new_tokens=3))
        done = b.run_until_drained()
        assert len(done) == 5
        assert all(len(r.generated) == 3 for r in done)
        assert b.slot_steps >= 5 * 2
        return _done(done), b.slot_steps
    both(body)


def test_interleaved_lengths_retire_independently():
    def body(B):
        b = make_batcher(B, capacity=3)
        b.submit(B.Request(0, np.array([1], np.int32), max_new_tokens=1))
        b.submit(B.Request(1, np.array([2], np.int32), max_new_tokens=6))
        b.submit(B.Request(2, np.array([3], np.int32), max_new_tokens=2))
        done = b.run_until_drained()
        assert sorted(r.rid for r in done) == [0, 1, 2]
        assert [len(r.generated)
                for r in sorted(done, key=lambda r: r.rid)] == [1, 6, 2]
        return _done(done), b.slot_steps
    both(body)


def test_positions_track_cache_growth():
    def body(B):
        b = make_batcher(B, capacity=1, max_seq=8)
        b.submit(B.Request(0, np.array([1, 2, 3], np.int32),
                           max_new_tokens=4))
        b._admit_all()
        assert b.slots.pos[0] == 3
        b.run_step()
        assert b.slots.pos[0] == 4
        return b.slots.pos.tolist()
    both(body)


@pytest.mark.parametrize("slots,steps", [(1, 2), (4, 8)])
def test_decode_loop_ppn_is_the_reference_network(slots, steps):
    """The engine's cyclic test network: the same processes, points and
    channels in both packages."""
    def body(B):
        ppn = B.decode_loop_ppn(slots, steps)
        return (ppn.kernel_name, dict(ppn.params),
                {n: (p.dims, p.pts.tolist(), p.stmt_rank)
                 for n, p in ppn.processes.items()},
                [(c.name, c.src_pts.tolist(), c.dst_pts.tolist())
                 for c in ppn.channels])
    both(body)
