"""The per-test time limit of the repo's root conftest.py: a test that runs
past it fails under its own name with the limit in its message, and the run
goes on to the next test."""
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 2

CONFTEST = f"""
import importlib.util

spec = importlib.util.spec_from_file_location(
    "repo_conftest", {os.path.join(REPO, "conftest.py")!r})
repo_conftest = importlib.util.module_from_spec(spec)
spec.loader.exec_module(repo_conftest)

pytest_runtest_call = repo_conftest.time_limiter({LIMIT})
"""

TESTS = """
import time


def test_sleeps_past_the_limit():
    time.sleep(60)


def test_after_it_passes():
    assert True
"""


def test_a_test_past_its_limit_fails_and_the_run_goes_on(tmp_path):
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "conftest.py").write_text(CONFTEST)
    (tmp_path / "test_child.py").write_text(TESTS)
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", "test_child.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    took = time.monotonic() - t0
    out = r.stdout
    assert r.returncode == 1, out + r.stderr
    assert "test_child.py::test_sleeps_past_the_limit FAILED" in out
    assert "test_child.py::test_after_it_passes PASSED" in out
    assert (f"test_child.py::test_sleeps_past_the_limit ran past its time "
            f"limit of {LIMIT} s") in out
    assert "1 failed, 1 passed" in out
    assert took < LIMIT + 20, took
