"""Batch preparation on a background thread (counterpart of
surfd_tpu/data/prefetch.py): one daemon thread assembles the next batches in
numpy while the main thread drives the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_iterator(it: Iterator[T], depth: int = 2) -> Iterator[T]:
    """The items of `it` in order, through a `depth`-deep queue filled by a
    daemon thread. An exception raised by `it` re-raises at the consumer's
    `next()`. Abandoning the iterator leaves the thread parked on a full
    queue until the process ends."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    q: queue.Queue = queue.Queue(maxsize=depth)

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_DONE)
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            q.put(_Raised(e))

    threading.Thread(target=worker, daemon=True, name="batch-prefetch").start()

    def gen():
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item

    return gen()
