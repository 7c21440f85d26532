"""Settings for the tests under tests/, besides tests/conftest.py:

- each test has a time limit of its own (TEST_TIME_LIMIT);
- the JAX package's native library is given back after each test;
- test_edit_pallas.py's banded case is marked slow.
"""
import signal
import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"

# Each test's own limit, well above the slowest tier-1 test: a test that
# hangs fails under its own name instead of holding its worker until the
# whole run is cut.
TEST_TIME_LIMIT = 240

# In interpret mode on the CPU, XLA compiles the Pallas edit kernel's banded
# body at its default 16 rows a grid step for minutes and then runs it for
# longer than a whole tier-1 run, whatever the input.
# test_edit_pallas_rows.py checks the same case at 2 and 4 rows a step.
SLOW = {"tests/test_edit_pallas.py::test_edit_pallas_matches_jax[0-64-True-0]"}


def time_limiter(seconds, under=None):
    """A hookwrapper for pytest_runtest_setup/call/teardown that fails a
    test still in that phase after `seconds`, for tests in the directory
    `under` (all tests if None). SIGALRM reaches the main thread, where
    pytest (and each xdist worker) runs its tests; its handler runs between
    bytecodes, so a test stuck in one long C call fails when it returns."""
    @pytest.hookimpl(hookwrapper=True)
    def limit(item):
        if under is not None and under not in item.path.parents:
            yield
            return

        def expire(signum, frame):
            pytest.fail(f"{item.nodeid} ran past its time limit of "
                        f"{seconds} s")
        old = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, seconds)
        yield  # a hookwrapper's yield returns the outcome, never raises
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
    return limit


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = \
    time_limiter(TEST_TIME_LIMIT, under=TESTS)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _jax_native_library_given_back():
    """bsalign_tpu.native decides once a process whether its library loads
    (`_TRIED`, `_LIB`). test_poa_native_diff.py resets both and runs with
    BSA_NO_NATIVE=1, which would leave the library off for every later
    test of its process; put back what the test found."""
    native = sys.modules.get("bsalign_tpu.native")
    saved = (native._TRIED, native._LIB) if native else (False, None)
    yield
    native = sys.modules.get("bsalign_tpu.native")
    if native is not None:
        native._TRIED, native._LIB = saved
