"""The JAX package's native library outlives a test that switches it off.
test_poa_native_diff.py runs the POA once with BSA_NO_NATIVE=1, which leaves
bsalign_tpu.native's library off in its module state; the root conftest.py
gives the library back once that test is torn down, so a later test of the
same process finds it again."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = "tests/test_native_given_back.py"


def test_library_loads():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    import bsalign_tpu.native.rowops as NR
    assert NR.available()


def test_native_off_run_gives_the_library_back():
    """In a process of its own, so xdist's order of files does not matter:
    every case of test_poa_native_diff.py, then test_library_loads."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", "-rs",
         "tests/test_poa_native_diff.py", f"{HERE}::test_library_loads"],
        cwd=REPO, capture_output=True, text=True, timeout=200)
    out = r.stdout
    assert r.returncode == 0, out + r.stderr
    assert "6 passed" in out and "skipped" not in out, out
