"""Guards of every test run from the repository's root: one torch thread per
test process, a wall-clock limit on each test's call, and one case too slow
for the suite left out."""
import contextlib
import faulthandler
import os
import signal
import tempfile
import time

# one intra-op thread per test process: torch takes a thread per core in each
# xdist worker, and several workers then oversubscribe the CPUs many times over
os.environ.setdefault("OMP_NUM_THREADS", "1")

import pytest  # noqa: E402

# wall-clock limit of one test's call phase: a hang fails that test, and the
# suite's own limit is left to the rest
TEST_SECONDS = 300
# the reference's heat-3d parametric parity case runs past that limit on its
# own (ROADMAP §3): left out until its template builds in seconds again
TOO_SLOW = ("tests/test_parametric.py::"
            "test_all_kernels_three_size_byte_parity[heat-3d]")


@contextlib.contextmanager
def _time_limit(seconds, nodeid):
    """Fail with ``nodeid`` and the stack if the body runs past ``seconds``.

    SIGALRM, so it runs on the main thread (as pytest and xdist's workers
    run tests).  On the way out the previous handler is put back and a timer
    that was running before is re-armed with what is left of it."""
    def expire(signum, frame):
        with tempfile.TemporaryFile("w+") as f:
            faulthandler.dump_traceback(f)
            f.seek(0)
            stack = f.read()
        pytest.fail(f"{nodeid} ran past its {seconds} s limit\n{stack}",
                    pytrace=False)

    previous = signal.signal(signal.SIGALRM, expire)
    outer, _ = signal.setitimer(signal.ITIMER_REAL, seconds)
    start = time.monotonic()
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        if outer:
            left = outer - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-6))


def pytest_collection_modifyitems(config, items):
    left_out = [item for item in items if item.nodeid == TOO_SLOW]
    if left_out:
        config.hook.pytest_deselected(items=left_out)
        items[:] = [item for item in items if item not in left_out]


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(TEST_SECONDS, item.nodeid):
        return (yield)


@pytest.fixture
def time_limit():
    """The guard the hook puts around each test, for tests of it."""
    return _time_limit
