"""Host data pipeline (``repro.data.pipeline`` in torch): background
prefetch with straggler mitigation, and a seekable stream wrapper.

Batches stay numpy dicts here; ``core.features.pack_group`` moves them to
the device inside the train step. If the generator thread misses its
deadline, the iterator yields the most recent spare instead of stalling the
synchronous step (the paper's Fig. 5 exposed-I/O fix).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional


class Prefetcher:
    """A worker thread keeps up to ``depth`` items of ``gen`` queued."""

    def __init__(self, gen: Iterator, depth: int = 4, timeout_s: float = 5.0):
        self.gen = gen
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.timeout_s = timeout_s
        self.backup: Any = None
        self.stats = {"produced": 0, "backup_served": 0}
        self._stop = False
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        for item in self.gen:
            if self._stop:
                return
            # a bounded put that keeps watching close(): a blocking put on a
            # full queue would never see _stop
            while not self._stop:
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if self._stop:
                return
            self.stats["produced"] += 1

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self.q.get(timeout=self.timeout_s)
            self.backup = item
            return item
        except queue.Empty:
            if self.backup is not None:  # straggler mitigation: serve the spare
                self.stats["backup_served"] += 1
                return self.backup
            raise StopIteration

    def close(self, join_timeout_s: float = 5.0):
        """Stop the worker and reap it: raise the stop flag, then drain the
        queue until the (possibly put-blocked) worker sees it and exits.
        Idempotent; the thread is a daemon, so a generator stuck inside
        ``next()`` cannot block interpreter exit."""
        self._stop = True
        deadline = time.monotonic() + join_timeout_s
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:  # make room so a blocked put() can complete and re-check
                self.q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


class ReplayableStream:
    """Seekable wrapper over a positional stream factory.

    ``make_iter(start)`` returns an iterator whose first item is the batch at
    absolute position ``start`` (see ``synthetic.batch_stream``). The wrapper
    tracks the position, so ``seek(step)`` replays exactly the batches a
    stretch consumed. Underlying iterators with a ``close()`` (Prefetcher)
    are closed on seek/close so their worker threads are reaped.
    """

    def __init__(self, make_iter: Callable[[int], Iterator], start: int = 0):
        self._make = make_iter
        self.pos = start
        self._it: Optional[Iterator] = None

    def _open(self):
        if self._it is None:
            self._it = self._make(self.pos)
        return self._it

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._open())
        self.pos += 1
        return item

    def seek(self, step: int) -> "ReplayableStream":
        if step != self.pos or self._it is None:
            self.close()
            self.pos = step
        return self

    def close(self):
        it, self._it = self._it, None
        if it is not None and hasattr(it, "close"):
            it.close()
