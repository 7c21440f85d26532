"""Build a shared library from sources on first use, keyed by their hash.

The library lands in the package's git-ignored `build/` directory as
`<name>-<hash>.so`. A file lock serialises concurrent builders (test
workers, several processes of one run); the compiler writes to a
temporary name that is renamed into place, so a reader never sees a
half-written library. A failed build raises with the compiler's stderr.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import time
from typing import List, Sequence, Tuple

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")


class BuildError(RuntimeError):
    pass


def build_shared(name: str, sources: Sequence[str], compile_cmd: List[str],
                 link_cmd: List[str], deps: Sequence[str] = ()
                 ) -> Tuple[str, float]:
    """Build `sources` into one shared library unless a library built from
    the same sources and commands exists: each source is compiled to an
    object by `compile_cmd + ["-c", src, "-o", obj]`, one compiler process
    per source, all started together, and `link_cmd + objects + ["-o",
    out]` links them. `deps` (headers the sources include) count in the
    hash. Returns the library's path and the seconds spent building (0.0
    when cached)."""
    h = hashlib.sha256(" ".join(compile_cmd + link_cmd).encode())
    for src in list(sources) + list(deps):
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, 0.0
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out, 0.0
        tmp = f"{out}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
        t0 = time.time()
        try:
            _run([compile_cmd + ["-c", src, "-o", obj]
                  for src, obj in zip(sources, objs)], name)
            _run([link_cmd + objs + ["-o", tmp]], name)
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        os.replace(tmp, out)
        return out, time.time() - t0


def _run(cmds: List[List[str]], name: str) -> None:
    """Run the commands as processes started together; raise on the first
    that failed, with its stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    for c, p, err in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise BuildError(f"building {name} failed ({' '.join(c)}):\n{err}")
