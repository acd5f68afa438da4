"""Prefetch thread shared by the host loaders: builds a generator's items
up to ``depth`` ahead, raises the thread's error in the consumer, and
stops and joins the thread when the consumer leaves the loop."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")


def prefetch(make: Callable[[], Iterator[T]], depth: int) -> Iterator[T]:
    """``make()``'s items in order; with ``depth`` > 0 a thread builds
    them, at most ``depth`` ahead."""
    if depth <= 0:
        yield from make()
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        items = make()
        try:
            for item in items:
                if not put(item):
                    return
            put(done)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            put(e)
        finally:
            items.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()
