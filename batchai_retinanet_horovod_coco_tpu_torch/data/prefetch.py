"""Background-thread prefetch, as the JAX package's ``data/prefetch.py``:
the one overlap idiom that the training loop and the eval driver share.

A producer thread pulls items and runs ``transfer`` on each, up to
``depth`` items ahead of the consumer, behind a bounded queue.  For device
prefetch ``transfer`` pins the host arrays and starts their copy to the
card on a side stream, so step k's compute overlaps batch k+1's copy and
the host work of producing it.

Error contract: an exception in the producer (from the item iterable or
from ``transfer``) is re-raised in the consumer; ``close()`` on the
returned generator stops the thread promptly even when the queue is full
(every put is stop-gated) and joins it.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Callable, Iterable, Iterator
from typing import TypeVar

from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import stop_gated_put

_T = TypeVar("_T")
_U = TypeVar("_U")


def prefetch_map(
    items: Iterable[_T],
    transfer: Callable[[_T], _U],
    depth: int = 2,
    thread_name: str = "prefetch-map",
) -> Iterator[_U]:
    """Yield ``transfer(item)`` for each item, with a background thread
    running up to ``depth`` items ahead; ``depth <= 0`` maps in line,
    without a thread."""
    if depth <= 0:
        for item in items:
            yield transfer(item)
        return

    buf: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()  # the stream is exhausted

    def feeder() -> None:
        try:
            for item in items:
                if not stop_gated_put(buf, transfer(item), stop):
                    return
            stop_gated_put(buf, end, stop)
        except BaseException as exc:  # handed to the consumer
            stop_gated_put(buf, exc, stop)

    thread = threading.Thread(target=feeder, daemon=True, name=thread_name)
    thread.start()
    try:
        while True:
            item = buf.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=30)
