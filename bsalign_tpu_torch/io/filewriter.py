"""FileWriter / BufferedWriter — background-thread buffered output.

Equivalent of filewriter.h: a writer thread drains a bounded queue
(filewriter.h:52-207), gz/pgzf compression chosen by file suffix, and a
multi-file tee. Text convenience wrappers included.
"""
from __future__ import annotations

import queue
import threading
from typing import List


class BufferedWriter:
    _END = object()

    def __init__(self, path_or_file, ncpu: int = 4, depth: int = 64):
        if isinstance(path_or_file, str):
            if path_or_file == "-":
                import os
                import sys
                self._f = os.fdopen(os.dup(sys.stdout.fileno()), "wb")
            elif path_or_file.endswith(".gz"):
                from .pgzf import PgzfWriter
                self._f = PgzfWriter(path_or_file, ncpu=ncpu)
            else:
                self._f = open(path_or_file, "wb")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        self._q: "queue.Queue" = queue.Queue(depth)
        self._exc = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            chunk = self._q.get()
            if chunk is self._END:
                return
            try:
                self._f.write(chunk)
            except BaseException as e:
                self._exc = e
                return

    def write(self, data) -> int:
        if self._exc:
            raise self._exc
        if isinstance(data, str):
            data = data.encode()
        self._q.put(data)
        return len(data)

    def close(self) -> None:
        self._q.put(self._END)
        self._t.join()
        if self._exc:
            raise self._exc
        if self._own:
            self._f.close()
        else:
            self._f.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TeeWriter:
    """Write the same stream to several sinks (filewriter.h multi-file)."""

    def __init__(self, writers: List):
        self.writers = writers

    def write(self, data) -> int:
        for w in self.writers:
            w.write(data)
        return len(data)

    def close(self) -> None:
        for w in self.writers:
            w.close()
