"""Background prefetching for host-side data pipelines.

The reference relies on torch DataLoader worker processes
(train_megapose.py DataLoader(n_workers, persistent)); image decode (PIL)
and tar reads release the GIL, so a thread pool + bounded queue gives the
same overlap without process plumbing. Used to keep the device fed while the
host decodes the next batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class PrefetchIterator:
    """Wrap an iterator; a worker thread keeps `depth` items ready."""

    def __init__(self, it: Iterable[T], depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # propagate into the consumer
                self._err = e
            finally:
                self._q.put(_SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[T]:
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(it: Iterable[T], depth: int = 4) -> PrefetchIterator:
    return PrefetchIterator(it, depth)
