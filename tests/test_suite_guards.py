"""The suite's own guards in the root ``conftest.py``: each test's time limit
and the one torch thread a test process runs with."""
import os
import signal
import time

import pytest
import torch


def test_time_limit_fails_the_body_and_puts_the_outer_limit_back(time_limit):
    # the hook's own limit is running around this test
    handler = signal.getsignal(signal.SIGALRM)
    outer, _ = signal.getitimer(signal.ITIMER_REAL)
    assert outer > 0
    with pytest.raises(pytest.fail.Exception, match="probe"):
        with time_limit(1, "probe"):
            time.sleep(3)
    assert signal.getsignal(signal.SIGALRM) is handler
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < left <= outer - 1


def test_torch_runs_one_thread_per_test_process():
    # the root conftest pins OMP_NUM_THREADS to 1 unless the environment set it
    assert torch.get_num_threads() == int(os.environ["OMP_NUM_THREADS"])
