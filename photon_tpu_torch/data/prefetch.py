"""Background batch prefetching (the port of ``photon_tpu/data/prefetch.py``).

CUDA launches are asynchronous, so the host loop is free while the device
computes, but the host-side shard gather would still serialize with the
step without a prefetcher. One daemon thread keeps a small queue of ready
batches.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np


class PrefetchIterator:
    """Wrap a batch iterator; pull ``depth`` batches ahead on a thread.

    Exceptions in the source iterator are re-raised at ``__next__``.
    NOT resumable itself — resume state lives in the underlying loader, which
    must not be advanced elsewhere while wrapped.
    """

    _DONE = object()

    def __init__(self, source, depth: int = 2) -> None:
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err: BaseException | None = None
        self._stopped = False
        self._thread = threading.Thread(
            target=self._fill, name="photon-prefetch", daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        """Stop-aware put: never blocks past a close(). A plain
        ``Queue.put`` deadlocks when the consumer is gone — the exact
        drain race ``close()`` used to lose (see below)."""
        while not self._stopped:
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self) -> None:
        try:
            for batch in self.source:
                if self._stopped or not self._put(batch):
                    return
        except BaseException as e:  # noqa: BLE001 — surfaced on the consumer side
            self._err = e
        self._put(self._DONE)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, timeout: float = 2.0) -> None:
        """Stop and JOIN the producer (with timeout).

        The old single-drain close lost a race: the producer could refill
        the queue after the drain and then block forever — in particular
        the ``put(_DONE)`` after source exhaustion had no stop check at
        all, leaking a permanently blocked thread. Now the producer's puts
        are stop-aware, and close keeps draining until the thread exits so
        any in-flight put is released."""
        self._stopped = True
        deadline = time.monotonic() + timeout
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
            if time.monotonic() >= deadline:
                break
