"""Host-side concurrency for the basecalling pipelines.

The reference runs every pipeline node on its own worker threads over bounded
AsyncQueues (dorado/read_pipeline/base/include/read_pipeline/base/
MessageSink.h:23-117; thread allocations utils/include/utils/parameters.h:
19-36).  This package folds the node graph into feeder -> device step ->
finisher, so host concurrency reduces to two thread pools around the device
step:

  - a *scale pool* runs POD5 decode + scaling/trim ahead of the feed loop,
  - a *finish pool* runs stitch + tag generation (modbase/barcode/polyA)
    behind the device step,

each wrapped in an :class:`OrderedPool` that yields results in submission
order with a bounded in-flight window.  Ordering keeps output records
deterministic (same order as the single-threaded loop); the window provides
the bounded-queue backpressure of the reference's AsyncQueue.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def default_host_threads() -> int:
    """Worker count per pool.

    Mirrors the reference's default of sizing thread pools from the host
    core count (utils/parameters.h:19-36), capped: host stages here are
    numpy-heavy (partially GIL-releasing), so wide pools stop paying off.
    """
    return min(8, max(2, (os.cpu_count() or 4) // 2))


class OrderedPool:
    """Map a function over an iterable on worker threads, yielding results
    in submission order with at most ``window`` items in flight.

    With ``workers=0`` the pool degrades to an inline map (no threads), which
    is bit-for-bit the single-threaded pipeline.
    """

    def __init__(self, fn: Callable[[T], R], workers: int, window: int | None = None):
        self.fn = fn
        self.workers = workers
        self.window = window if window is not None else max(2, workers * 4)
        self._pool = ThreadPoolExecutor(max_workers=workers) if workers > 0 else None

    def map(self, items: Iterable[T]) -> Iterator[R]:
        if self._pool is None:
            for item in items:
                yield self.fn(item)
            return
        inflight: deque = deque()
        it = iter(items)
        exhausted = False
        try:
            while True:
                while not exhausted and len(inflight) < self.window:
                    try:
                        item = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    inflight.append(self._pool.submit(self.fn, item))
                if not inflight:
                    break
                yield inflight.popleft().result()
        finally:
            # on early exit (exception downstream), let queued work finish so
            # worker exceptions don't land after interpreter teardown
            for f in inflight:
                f.cancel()

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class OrderedSink:
    """Submit work to a pool; drain completed results in submission order.

    The producer calls :meth:`submit` as items become ready and
    :meth:`drain_ready` opportunistically (non-blocking except when the
    window is full); :meth:`drain_all` blocks until everything is consumed.
    Consumption happens on the caller's thread via ``consume``.
    """

    def __init__(
        self,
        fn: Callable[[T], R],
        consume: Callable[[R], None],
        workers: int,
        window: int | None = None,
    ):
        self.fn = fn
        self.consume = consume
        self.workers = workers
        self.window = window if window is not None else max(2, workers * 4)
        self._pool = ThreadPoolExecutor(max_workers=workers) if workers > 0 else None
        self._inflight: deque = deque()

    def submit(self, item: T) -> None:
        if self._pool is None:
            self.consume(self.fn(item))
            return
        self._inflight.append(self._pool.submit(self.fn, item))
        if len(self._inflight) >= self.window:
            self.consume(self._inflight.popleft().result())
        else:
            self.drain_ready()

    def drain_ready(self) -> None:
        while self._inflight and self._inflight[0].done():
            self.consume(self._inflight.popleft().result())

    def drain_all(self) -> None:
        while self._inflight:
            self.consume(self._inflight.popleft().result())

    def shutdown(self) -> None:
        self.drain_all()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
