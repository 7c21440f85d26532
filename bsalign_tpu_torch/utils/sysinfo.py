"""Process / system introspection.

Equivalent of mem_share.h's /proc parsing (get_linux_sys_info
mem_share.h:542, print_proc_stat_info :624): total/available memory, RSS,
user/sys CPU time, with a SIGUSR-style dump hook.
"""
from __future__ import annotations

import os
import signal
import sys
import time

_T0 = time.time()


def get_linux_sys_info() -> dict:
    info = {"mem_total": 0, "mem_free": 0, "mem_available": 0}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                val = int(v.strip().split()[0]) * 1024
                if k == "MemTotal":
                    info["mem_total"] = val
                elif k == "MemFree":
                    info["mem_free"] = val
                elif k == "MemAvailable":
                    info["mem_available"] = val
    except OSError:
        pass
    return info


def proc_stat_info(pid: int = 0) -> dict:
    """utime/stime/vsize/rss from /proc/<pid>/stat (mem_share.h:581-640)."""
    pid = pid or os.getpid()
    try:
        with open(f"/proc/{pid}/stat") as f:
            parts = f.read().split()
        tck = os.sysconf("SC_CLK_TCK")
        page = os.sysconf("SC_PAGE_SIZE")
        return {
            "utime_s": int(parts[13]) / tck,
            "stime_s": int(parts[14]) / tck,
            "vsize_bytes": int(parts[22]),
            "rss_bytes": int(parts[23]) * page,
            "wall_s": time.time() - _T0,
        }
    except (OSError, IndexError, ValueError):
        return {}


def print_proc_stat_info(sig_or_pid=0, out=None) -> None:
    info = proc_stat_info()
    out = out or sys.stderr
    out.write("[PROC] utime=%.2fs stime=%.2fs rss=%.1fMB wall=%.2fs\n" % (
        info.get("utime_s", 0), info.get("stime_s", 0),
        info.get("rss_bytes", 0) / 1e6, info.get("wall_s", 0)))


def install_stat_signal(signum: int = signal.SIGUSR1) -> None:
    """Dump process stats on signal, like the reference's handler."""
    signal.signal(signum, lambda s, f: print_proc_stat_info())


def microtime() -> int:
    """Microseconds since epoch (mem_share.h:292)."""
    return int(time.time() * 1e6)
