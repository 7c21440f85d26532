"""Worker-pool utilities.

Equivalent of thread.h's `thread_beg_def/.../thread_wake/wait` macro
framework (thread.h:43-241): a small ordered task pool used by the I/O
layer (pgzf codec workers, async reader/writer threads). Python threads are
adequate here because the heavy work (zlib, disk) releases the GIL.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional


class OrderedPool:
    """N workers apply `fn` to tasks; results come back in submit order
    (the pgzf pattern: parallel deflate, sequential write)."""

    def __init__(self, n_workers: int, fn: Callable):
        self.fn = fn
        self.n = max(1, n_workers)
        self._inq: "queue.Queue" = queue.Queue(self.n * 4)
        self._done: dict = {}
        self._cv = threading.Condition()
        self._next_emit = 0
        self._next_id = 0
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(self.n)]
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            item = self._inq.get()
            if item is None:
                return
            tid, arg = item
            try:
                res = (True, self.fn(arg))
            except Exception as e:  # surfaced on collect
                res = (False, e)
            with self._cv:
                self._done[tid] = res
                self._cv.notify_all()

    def submit(self, arg) -> int:
        tid = self._next_id
        self._next_id += 1
        self._inq.put((tid, arg))
        return tid

    def collect(self) -> Iterator:
        """Yield completed results in submission order (blocking)."""
        while self._next_emit < self._next_id:
            with self._cv:
                while self._next_emit not in self._done:
                    self._cv.wait()
                ok, res = self._done.pop(self._next_emit)
            self._next_emit += 1
            if not ok:
                raise res
            yield res

    def map(self, args: Iterable) -> Iterator:
        for a in args:
            self.submit(a)
        yield from self.collect()

    def close(self):
        for _ in self._threads:
            self._inq.put(None)
        for t in self._threads:
            t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Prefetcher:
    """Background producer thread with a bounded queue (filereader.h:105's
    async reader / filewriter.h:52's buffered writer pattern)."""

    _END = object()

    def __init__(self, it: Iterable, depth: int = 8):
        self._q: "queue.Queue" = queue.Queue(depth)
        self._exc: Optional[BaseException] = None

        def run():
            try:
                for x in it:
                    self._q.put(x)
            except BaseException as e:
                self._exc = e
            finally:
                self._q.put(self._END)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        while True:
            x = self._q.get()
            if x is self._END:
                if self._exc:
                    raise self._exc
                return
            yield x
