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

Observability: the thread registers a watchdog heartbeat under its name
and spans each ``transfer`` under that name.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Callable, Iterable, Iterator
from typing import TypeVar

from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import stop_gated_put
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace, watchdog

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
        # Every produced item is a heartbeat and a span; idle() before the
        # bounded put: a full queue is a busy consumer, not a stall.
        hb = watchdog.register(
            thread_name, details=lambda: {"qsize": buf.qsize(), "depth": depth}
        )
        try:
            for item in items:
                with trace.span(thread_name):
                    staged = transfer(item)
                hb.beat()
                hb.idle()
                if not stop_gated_put(buf, staged, stop):
                    return
                hb.beat()
            hb.idle()  # the end marker waits on the same backpressure
            stop_gated_put(buf, end, stop)
        except BaseException as exc:  # handed to the consumer
            hb.idle()
            stop_gated_put(buf, exc, stop)
        finally:
            hb.close()

    # watchdog: registers in feeder() at thread start.
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
