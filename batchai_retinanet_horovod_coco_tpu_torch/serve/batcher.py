"""Per-bucket slot-pool batcher with continuous in-flight admission.

The JAX package's ``serve/batcher.py``.  One
``BucketBatcher`` thread per shape bucket pulls preprocessed requests from
its bounded queue and claims them into a ``SlotPool`` — the batch currently
being ASSEMBLED.  The pool seals (assembles a padded device batch and hands
it to the dispatcher) when:

- it is FULL (every slot of the bucket's largest batch claimed);
- the coalescing deadline (``max_delay_ms`` since the FIRST claim) fires;
- **continuous mode only**: the dispatch gate reports the device is ready,
  so a partial batch rides immediately instead of padding out the deadline.

Expired requests are rejected at claim time, and a claimed request whose
deadline expires before the seal is evicted at the seal, under the pool
lock.  Assembly uses the pipeline's pad template and row layout (image at
the top-left corner, dataset-mean pad margins), so a served row is
byte-identical to the row the eval pipeline would build.  The handoff to
the dispatcher is a bounded stop-gated put: a slow device backpressures
the batcher, and queue bounds upstream turn overload into sheds.  Each
batcher heartbeats as ``serve-batcher-<H>x<W>`` (idle while the dispatch
queue is full: device backpressure, not a stall) and spans its assembly as
``serve_assemble``; a sealed batch carries each row's slot wait.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import (
    _pad_template,
    paste_image,
    stop_gated_put,
)
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace, watchdog
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import (
    AssembledBatch,
    RequestTimeout,
    ServeRequest,
    ServerClosed,
    monotonic_s,
)


class SlotPool:
    """The batch currently being assembled for one bucket, slot-granular.

    ``claim()`` takes a free slot; ``seal()`` atomically evicts expired
    claims and takes every live row (resetting the pool) under ONE lock
    acquisition, so an eviction racing the seal can neither orphan a
    claimed slot nor leak a dead row into the sealed batch.  ``now_fn`` is
    injectable for race-shaped tests.
    """

    def __init__(self, capacity: int, now_fn: Callable[[], float] = monotonic_s):
        self.capacity = max(1, int(capacity))
        self._now = now_fn
        self._lock = threading.Lock()
        self._rows: list[ServeRequest] = []
        self._claim_t: list[float] = []
        self.first_claim_t: float | None = None
        self.evictions = 0

    def claim(self, req: ServeRequest) -> bool:
        """Claim one free slot for ``req``; False when the pool is full
        (the caller seals first, then re-claims)."""
        with self._lock:
            if len(self._rows) >= self.capacity:
                return False
            now = self._now()
            if not self._rows:
                self.first_claim_t = now
            self._rows.append(req)
            self._claim_t.append(now)
            return True

    def size(self) -> int:
        with self._lock:
            return len(self._rows)

    def free_slots(self) -> int:
        with self._lock:
            return self.capacity - len(self._rows)

    def fire_deadline(self, max_delay_s: float) -> float | None:
        """When the coalescing deadline fires for the current assembly
        (None while the pool is empty)."""
        with self._lock:
            if self.first_claim_t is None:
                return None
            return self.first_claim_t + max_delay_s

    def seal(
        self, on_evict: Callable[[ServeRequest, BaseException], None]
    ) -> tuple[list[ServeRequest], list[float]]:
        """Atomically evict expired claims, take every live row, reset.

        Returns ``(rows, slot_wait_ms)``, row-aligned: the live rows and
        the ms each waited between its claim and this seal.  Evicted
        requests are rejected with ``RequestTimeout`` AFTER the lock is
        released; their slots are already free by then.
        """
        now = self._now()
        with self._lock:
            rows, waits, evicted = [], [], []
            for req, t in zip(self._rows, self._claim_t):
                if req.expired(now=now):
                    evicted.append(req)
                else:
                    rows.append(req)
                    waits.append((now - t) * 1e3)
            self._rows = []
            self._claim_t = []
            self.first_claim_t = None
            self.evictions += len(evicted)
        for req in evicted:
            on_evict(req, RequestTimeout(
                f"request {req.id} expired in its claimed slot"
            ))
        return rows, waits


def assemble_requests(
    requests: list[ServeRequest],
    hw: tuple[int, int],
    batch_size: int,
    slot_wait_ms: tuple = (),
) -> AssembledBatch:
    """Pad ≤``batch_size`` preprocessed requests into one device batch;
    surplus rows are whole pad-template slots with ``valid=False``."""
    bh, bw = hw
    pad = _pad_template(bh, bw)
    images = np.empty((batch_size, bh, bw, 3), dtype=np.uint8)
    scales = np.ones((batch_size,), dtype=np.float32)
    valid = np.zeros((batch_size,), dtype=bool)
    for i, req in enumerate(requests):
        paste_image(images[i], req.image, pad)
        scales[i] = req.scale
        valid[i] = True
    for i in range(len(requests), batch_size):
        images[i] = pad
    return AssembledBatch(
        hw=hw,
        images=images,
        requests=list(requests),
        scales=scales,
        valid=valid,
        slot_wait_ms=tuple(slot_wait_ms),
    )


class BucketBatcher:
    """One bucket's slot-pool admission thread."""

    _POLL_S = 0.05
    # While slots are claimed the loop polls tightly: a seal must notice
    # the dispatch gate / deadline within ~one dispatch overhead.
    _ARMED_POLL_S = 0.002

    def __init__(
        self,
        hw: tuple[int, int],
        engine,
        in_queue: queue.Queue,
        dispatch_queue: queue.Queue,
        max_delay_ms: float,
        on_reject: Callable[[ServeRequest, BaseException], None],
        on_fatal: Callable[[BaseException], None],
        stop: threading.Event,
        gate=None,  # DispatchGate (continuous mode) or None (deadline-only)
    ):
        self.hw = hw
        self._engine = engine
        self._in = in_queue
        self._out = dispatch_queue
        self._max_delay_s = max(0.0, max_delay_ms) / 1e3
        self._on_reject = on_reject
        self._on_fatal = on_fatal
        self._stop = stop
        self._gate = gate
        self.pool = SlotPool(engine.max_batch(hw))
        self.batches = 0
        self.deadline_fires = 0
        self.full_fires = 0
        self.ready_fires = 0  # continuous seals: the device asked
        self.thread = threading.Thread(
            target=self._run,
            daemon=True,
            name=f"serve-batcher-{hw[0]}x{hw[1]}",
        )
        self.thread.start()

    def _take_live(self, timeout: float) -> ServeRequest | None:
        """Next non-expired request within ``timeout`` (expired ones are
        rejected in passing), else None."""
        deadline = monotonic_s() + timeout
        while True:
            remaining = deadline - monotonic_s()
            if remaining <= 0:
                return None
            try:
                req = self._in.get(timeout=min(remaining, self._POLL_S))
            except queue.Empty:
                if self._stop.is_set():
                    return None
                continue
            if req.expired():
                self._on_reject(req, RequestTimeout(
                    f"request {req.id} expired waiting for a batch"
                ))
                continue
            return req

    def _claim(self, req: ServeRequest) -> bool:
        """Claim + arm: the gate's armed flag tells the dispatcher that a
        post-fetch handoff wait can actually yield a batch."""
        ok = self.pool.claim(req)
        if ok and self._gate is not None:
            self._gate.arm(self.hw)
        return ok

    def _drain_claims(self) -> None:
        """Claim every immediately-available live request up to capacity —
        the last admission sweep before a seal."""
        while self.pool.free_slots() > 0:
            try:
                req = self._in.get_nowait()
            except queue.Empty:
                return
            if req.expired():
                self._on_reject(req, RequestTimeout(
                    f"request {req.id} expired waiting for a batch"
                ))
                continue
            self._claim(req)

    def _seal_reason(self) -> str | None:
        """Why the assembling batch should seal NOW, or None.

        Deadline-only mode seals at {full, deadline}.  Continuous mode
        seals at {full, ready}; its deadline survives as a stall rescue and
        as the drain flush.
        """
        n = self.pool.size()
        if n == 0:
            return None
        if n >= self.pool.capacity:
            return "full"
        now = monotonic_s()
        fire_at = self.pool.fire_deadline(self._max_delay_s)
        if self._gate is None:
            if fire_at is not None and now >= fire_at:
                return "deadline"
        else:
            if self._gate.is_ready() and self._out.empty():
                return "ready"
            # Unconditional rescue: a saturated sibling bucket can keep the
            # shared dispatch queue non-empty; past this point the pool
            # seals regardless (the bounded put is the backpressure).
            rescue_at = (fire_at or now) + max(0.1, self._max_delay_s)
            if now >= rescue_at:
                return "deadline"
        if self._stop.is_set():
            return "deadline"  # draining: flush what is claimed
        return None

    def _seal_and_dispatch(self, hb: watchdog.Heartbeat, reason: str) -> bool:
        """Assemble the pool into a padded batch and hand it over; False
        when the server closed under the put."""
        self._drain_claims()
        if self.pool.size() >= self.pool.capacity:
            reason = "full"
        rows, waits = self.pool.seal(self._on_reject)
        if self._gate is not None:
            self._gate.disarm(self.hw)  # the pool is empty again
        if not rows:
            return True  # every claim expired — nothing rides
        if reason == "full":
            self.full_fires += 1
        elif reason == "ready":
            self.ready_fires += 1
            self._gate.clear()
        else:
            self.deadline_fires += 1
        bsize = self._engine.batch_size_for(self.hw, len(rows))
        with trace.span(
            "serve_assemble", bucket=f"{self.hw[0]}x{self.hw[1]}", n=len(rows),
            padded_to=bsize, reason=reason,
        ):
            assembled = assemble_requests(rows, self.hw, bsize, waits)
        self.batches += 1
        hb.idle()  # a full dispatch queue is device backpressure
        if not stop_gated_put(self._out, assembled, self._stop):
            for req in rows:
                self._on_reject(req, ServerClosed("server closed mid-batch"))
            return False
        hb.beat()
        return True

    def _claim_timeout(self) -> float:
        """How long the claim phase may block on the in-queue before the
        seal conditions are re-checked."""
        n = self.pool.size()
        if n == 0:
            return self._POLL_S
        fire_at = self.pool.fire_deadline(self._max_delay_s)
        remaining = max(0.0, (fire_at or 0.0) - monotonic_s())
        if self._gate is not None:
            # Continuous: wake fast enough to catch the dispatch gate.
            return min(self._ARMED_POLL_S, remaining) or self._ARMED_POLL_S
        return min(self._POLL_S, max(remaining, 1e-4))

    def _run(self) -> None:
        hb = watchdog.register(
            f"serve-batcher-{self.hw[0]}x{self.hw[1]}",
            details=lambda: {
                "qsize": self._in.qsize(),
                "claimed": self.pool.size(),
                "batches": self.batches,
            },
        )
        try:
            while True:
                hb.beat()
                if self._stop.is_set():
                    return
                req = self._take_live(self._claim_timeout())
                if req is not None and not self._claim(req):
                    # Full pool racing an empty seal (every claim had
                    # expired): seal to make room, then the claim holds.
                    if not self._seal_and_dispatch(hb, "full"):
                        self._on_reject(
                            req, ServerClosed("server closed mid-batch")
                        )
                        return
                    self._claim(req)
                reason = self._seal_reason()
                if reason is None:
                    continue
                if not self._seal_and_dispatch(hb, reason):
                    return
        except Exception as exc:  # routed to the frontend: fails every future
            self._on_fatal(exc)
        finally:
            hb.close()
