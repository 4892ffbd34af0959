"""Multiprocess shared-memory input pipeline, as the JAX package's
``data/shm_pipeline.py``: decode, augment and resize in worker processes.

Why: the thread-pool producer (``pipeline.py``) runs its decodes in the
training process, and their torch ops (the resize, the warp) take cores
from the step.  Here the fan-out runs in ``num_worker_procs`` WORKER
PROCESSES instead, each writing its decoded image straight into a
preallocated POSIX shared-memory slab, so only a few ints and the small gt
arrays cross the process boundary by pickling, never an image.

Architecture
------------
- One shared-memory **slab per bucket shape**: ``(slots, H, W, 3)`` uint8.
  Slots are a free list the parent manages; a worker writes example
  ``seq`` into its assigned slot and reports ``(seq, h, w, boxes, labels,
  scale, cuda)`` on the result queue (``cuda``: whether CUDA is
  initialized in the worker, which it never should be).
- The **parent coordinator** (a thread, as the thread path's producer)
  plans batches with the same ``batch_plans`` / ``example_rng`` the thread
  path uses, assigns slots, and assembles finished batches IN SUBMISSION
  ORDER with the same ``assemble`` / ``pad_batch``, so for a fixed seed the
  two paths give the same batches, bit for bit.
- ``PipelineStats`` is counted at assembly, in the parent.

Robustness contract (``tests/test_torch_shm_pipeline.py``):
- a worker CRASH raises ``RuntimeError`` in the consumer within about a
  second (a liveness poll on every pump), after the children are reaped and
  the shared memory unlinked;
- a worker WEDGE (alive but stuck) trips ``config.worker_timeout`` on the
  head-of-line batch, never a silent hang (a worker still starting up, which
  has not reported ready, gets ``_START_GRACE_S`` more);
- a worker's exception reaches the consumer with its traceback;
- ``close()`` is idempotent and reaps every child and ``/dev/shm``
  segment; a ``weakref.finalize`` backstops a consumer that drops the
  iterator without closing it.

Workers are ``spawn``ed, never forked: a process that has initialized CUDA
must not fork, and a worker needs only the data layer.  It never touches
CUDA, and nothing pickled to it holds a CUDA tensor.  Each worker runs
torch on one thread (``torch.set_num_threads(1)``): N workers already fill
N cores, and a pool the size of the host in each would fight them.  The
parent builds the codec library before it spawns, so the workers load it
instead of compiling it all at once.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback
import uuid
import weakref
from collections import deque
from multiprocessing import shared_memory

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import (
    _PREFETCH,
    Batch,
    PipelineConfig,
    PipelineStats,
    assemble,
    batch_plans,
    example_rng,
    load_example,
    pad_batch,
    stop_gated_put,
)
from batchai_retinanet_horovod_coco_tpu_torch.native import build
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace, watchdog

_SENTINEL = object()
# A worker that has not reported ready is starting (spawning, importing
# torch), not wedged: the stall clock allows it this much more.
_START_GRACE_S = 60.0
# Distinct from the JAX package's "bretshm": each package's tests scan
# /dev/shm for their own prefix, and may run beside the other's.
SHM_PREFIX = "rtorchshm"


class _StopRequested(Exception):
    """The consumer closed the pipeline; unwind the producer."""


def _attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment WITHOUT registering it with this
    process's resource tracker.

    The parent owns the segments (creates once, unlinks once).  Spawned
    children share the parent's resource-tracker process, so a child attach
    that registers (as ``SharedMemory`` does before Python 3.13) would race
    the parent's unlink-time unregister, or unlink the parent's segment when
    the child exits.  Python 3.13 has ``track=False`` for this; before it,
    the registration call is suppressed for the length of the attach.
    """
    try:
        return shared_memory.SharedMemory(name=name, track=False)  # py>=3.13
    except TypeError:
        pass
    from multiprocessing import resource_tracker

    orig_register = resource_tracker.register

    def _no_shm_register(rname, rtype):
        if rtype != "shared_memory":
            orig_register(rname, rtype)

    resource_tracker.register = _no_shm_register
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig_register


def _worker_main(
    worker_id: int,
    dataset,
    config: PipelineConfig,
    train: bool,
    slabs: list[tuple[str, tuple[int, ...], str]],
    task_q,
    result_q,
    stop_evt,
) -> None:
    """Worker-process loop: task → decode/augment/resize → shm slot.

    Tasks are ``(seq, epoch, idx, bucket_id, slot)``; the image lands in
    ``slabs[bucket_id][slot]`` and only the small result tuple is pickled
    back.  Any failure is reported on the result queue, with the traceback,
    before a hard exit, so the parent can raise it.
    """
    import signal

    import torch

    signal.signal(signal.SIGINT, signal.SIG_IGN)  # the parent owns Ctrl-C
    # One thread of torch ops (the resize, the warp) per worker.
    torch.set_num_threads(1)
    # Tracing turns itself on when the parent exported the obs environment
    # before the spawn; the spans go to this process's own trace file
    # (exported on a clean exit) and merge into the parent's timeline.
    tracing = trace.maybe_configure_from_env(f"shm-worker-{worker_id}")
    shms: list[shared_memory.SharedMemory] = []
    views: list[np.ndarray] = []
    try:
        for name, shape, dtype in slabs:
            shm = _attach_shm(name)
            shms.append(shm)
            views.append(np.ndarray(shape, dtype=np.dtype(dtype), buffer=shm.buf))
        result_q.put(("ready", worker_id))
        while not stop_evt.is_set():
            try:
                task = task_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if task is None:
                break
            seq, epoch, idx, bucket_id, slot = task
            with trace.span("decode"):
                img, boxes, labels, scale = load_example(
                    dataset, dataset.records[idx], config,
                    example_rng(config, train, epoch, idx), config.buckets[bucket_id],
                )
            h, w = img.shape[:2]
            with trace.span("shm_write"):
                views[bucket_id][slot, :h, :w] = img
            result_q.put(("ok", seq, h, w, boxes, labels, scale, torch.cuda.is_initialized()))
        if tracing:
            trace.export()  # a clean exit only: a crashed worker's trace is lost
    except BaseException:
        try:
            result_q.put(("err", worker_id, traceback.format_exc()))
            # Flush the queue's feeder thread BEFORE the hard exit, or the
            # report can die in its buffer and the parent sees only a death.
            result_q.close()
            result_q.join_thread()
        except Exception:
            pass
        os._exit(1)
    finally:
        views.clear()  # drop the buffer exports before closing the mappings
        for shm in shms:
            try:
                shm.close()
            except BufferError:
                pass


def _finalize_pipeline(stop, mp_stop, procs, task_q, result_q, shms, views):
    """Teardown from ``close()`` or garbage collection: also stops the
    coordinator thread.

    The producer's own exit path calls ``_cleanup_resources`` instead: it
    must NOT set ``stop``, because after an error it still has an exception
    to deliver through the stop-gated output queue.
    """
    stop.set()
    _cleanup_resources(mp_stop, procs, task_q, result_q, shms, views)


def _cleanup_resources(mp_stop, procs, task_q, result_q, shms, views) -> None:
    """Reap the children and unlink the shared memory.  Idempotent; never
    raises."""
    mp_stop.set()
    for _ in procs:
        try:
            task_q.put_nowait(None)
        except Exception:
            pass
    deadline = trace.monotonic_s() + 5.0
    for p in procs:
        try:
            p.join(timeout=max(0.1, deadline - trace.monotonic_s()))
        except Exception:
            pass
    for p in procs:
        try:
            if p.is_alive():
                p.terminate()
        except Exception:
            pass
    for p in procs:
        try:
            p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=2.0)
        except Exception:
            pass
    for q in (task_q, result_q):
        try:
            q.cancel_join_thread()
            q.close()
        except Exception:
            pass
    views.clear()  # release the buffer exports so the mappings can close
    for shm in shms:
        try:
            shm.close()
        except Exception:
            pass
        try:
            shm.unlink()
        except Exception:
            pass


class _ShmPipeline:
    """Iterator over batches produced by worker processes.

    The thread path's surface (iteration, live ``stats``, ``close()``), and
    for tests and tools: ``processes`` (the ``multiprocessing.Process``
    objects), ``shm_names``, and ``workers_touched_cuda`` (whether any
    worker reported CUDA initialized).
    """

    def __init__(self, dataset, config: PipelineConfig, train: bool):
        import multiprocessing as mp

        if config.num_worker_procs <= 0:
            raise ValueError("build_shm_pipeline needs num_worker_procs > 0")
        self._config = config
        self._dataset = dataset
        self._train = train
        self.stats = PipelineStats()
        self.workers_touched_cuda = False
        ctx = mp.get_context("spawn")
        # Built here, once: N workers would otherwise compile it side by side.
        build.compile_library("imagecodec")

        # The thread path's in-flight batch window, so neither path drains
        # its workers at a batch boundary; one more batch of slots covers the
        # batch being planned (its slots are taken before it joins the deque).
        bs = max(1, config.batch_size)
        self._max_inflight = max(2, -(-config.num_worker_procs // bs) + 1)
        self._slots_per_bucket = bs * (self._max_inflight + 1)
        run_id = f"{SHM_PREFIX}{os.getpid()}_{uuid.uuid4().hex[:6]}"
        self._shms: list[shared_memory.SharedMemory] = []
        self._views: list[np.ndarray] = []
        self._slab_spec: list[tuple[str, tuple[int, ...], str]] = []
        try:
            for k, (bh, bw) in enumerate(config.buckets):
                shape = (self._slots_per_bucket, bh, bw, 3)
                shm = shared_memory.SharedMemory(name=f"{run_id}_{k}", create=True,
                                                 size=int(np.prod(shape)))
                self._shms.append(shm)
                self._views.append(np.ndarray(shape, dtype=np.uint8, buffer=shm.buf))
                self._slab_spec.append((shm.name, shape, np.dtype(np.uint8).str))
        except BaseException:
            # A create that fails partway (a small /dev/shm raises ENOSPC on
            # slab k) comes BEFORE the finalizer below exists: unlink slabs
            # 0..k-1 here, or they outlive the process.
            self._views.clear()
            for shm in self._shms:
                try:
                    shm.close()
                    shm.unlink()
                except Exception:
                    pass
            raise
        self.shm_names = [s.name for s in self._shms]
        self._bucket_ids = {b: i for i, b in enumerate(config.buckets)}

        # In-flight tasks and results are bounded by the slots: the
        # coordinator submits only while it holds a free slot.
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._mp_stop = ctx.Event()
        # The workers do not register with the watchdog: the coordinator
        # beats for them on every result that arrives (_pump_until).
        self.processes = [
            ctx.Process(
                target=_worker_main,
                args=(w, dataset, config, train, self._slab_spec,
                      self._task_q, self._result_q, self._mp_stop),
                daemon=True,
                name=f"shm-pipe-worker-{w}",
            )
            for w in range(config.num_worker_procs)
        ]

        # Producer state, touched only by the coordinator thread.
        self._out: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        self._stop = threading.Event()
        self._free: list[deque] = [deque(range(self._slots_per_bucket)) for _ in config.buckets]
        self._inflight: deque = deque()
        self._results: dict[int, tuple] = {}
        self._seq_slot: dict[int, tuple[int, int]] = {}
        self._ready: set[int] = set()  # workers that reported ready
        self._next_seq = 0
        self._finished = False  # the stream ended (its end or an exception)
        self._last_liveness = 0.0  # the last liveness poll (monotonic)

        # The backstop exists BEFORE any child starts: a spawn that fails
        # halfway still reaps and unlinks at collection.
        self._finalizer = weakref.finalize(
            self, _finalize_pipeline, self._stop, self._mp_stop, self.processes,
            self._task_q, self._result_q, self._shms, self._views,
        )
        for p in self.processes:
            p.start()
        self._hb = None  # registered by the coordinator thread itself
        # watchdog: registers in _producer() at thread start.
        self._thread = threading.Thread(target=self._producer, daemon=True,
                                        name="shm-pipe-coordinator")
        self._thread.start()

    # ---- consumer surface ------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        if self._finished:
            # As a generator: once the stream ended, next() raises
            # StopIteration instead of blocking on a dead queue.
            raise StopIteration
        item = self._out.get()
        if item is _SENTINEL:
            self._finished = True
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            # The producer reaped the children and unlinked the memory
            # before it delivered this; close() stops its thread.
            self._finished = True
            self.close()
            raise item
        return item

    def close(self) -> None:
        """Stop the coordinator, reap every child, unlink every segment."""
        self._stop.set()
        if self._thread.is_alive() and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)
        self._finalizer()

    # ---- producer (coordinator thread) -----------------------------------

    def _put(self, item) -> bool:
        return stop_gated_put(self._out, item, self._stop)

    def _take(self, msg) -> None:
        """Record a worker's message, or raise the error it reports."""
        if msg[0] == "err":
            raise RuntimeError(f"input-pipeline worker {msg[1]} failed:\n{msg[2]}")
        if msg[0] == "ready":
            self._ready.add(msg[1])
            return
        _, seq, h, w, boxes, labels, scale, cuda = msg
        self._results[seq] = (h, w, boxes, labels, scale)
        self.workers_touched_cuda |= bool(cuda)

    def _check_workers(self) -> None:
        self._last_liveness = trace.monotonic_s()
        for p in self.processes:
            if not p.is_alive():
                # Prefer the worker's own report: a worker that failed queues
                # its traceback and exits, and this poll can win the race
                # against the queue's feeder thread.  Drain briefly first.
                grace = trace.monotonic_s() + 1.0
                while trace.monotonic_s() < grace:
                    try:
                        self._take(self._result_q.get_nowait())
                    except queue.Empty:
                        time.sleep(0.05)
                raise RuntimeError(
                    f"input-pipeline worker {p.name} (pid {p.pid}) died unexpectedly with "
                    f"exit code {p.exitcode}; the decode workers are no longer intact"
                )

    def _pump_until(self, cond) -> None:
        """Drain worker results until ``cond()`` holds.

        Raises on a consumer stop, a worker's error or death, or when no
        message arrives within ``config.worker_timeout`` (an alive but stuck
        worker is seen only by a timeout), plus ``_START_GRACE_S`` while a
        worker has yet to report ready.
        """
        last = trace.monotonic_s()
        while not cond():
            if self._stop.is_set():
                raise _StopRequested
            # Liveness at a bounded cadence even while results flow: with
            # one dead worker and N-1 healthy ones the queue may never drain.
            if trace.monotonic_s() - self._last_liveness > 0.5:
                self._check_workers()
            try:
                msg = self._result_q.get(timeout=0.1)
            except queue.Empty:
                msg = None
            if msg is not None:
                self._take(msg)
                # Any result is progress: the timeout bounds a stall, not the
                # head batch's whole latency.  It is also the workers' beat.
                if self._hb is not None:
                    self._hb.beat()
                last = trace.monotonic_s()
                continue
            self._check_workers()
            allowed = self._config.worker_timeout
            if len(self._ready) < len(self.processes):
                allowed += _START_GRACE_S
            if trace.monotonic_s() - last > allowed:
                raise RuntimeError(
                    "input pipeline stalled: no progress on the head batch within "
                    f"worker_timeout={self._config.worker_timeout}s "
                    f"({self._config.num_worker_procs} workers alive, {len(self._ready)} of them "
                    "started, but not delivering: a wedged worker, or a decode slower than "
                    "the timeout allows)"
                )

    def _acquire_slot(self, bucket_id: int) -> int:
        while not self._free[bucket_id]:
            # Slots recycle at assembly, so flushing the head batch is the
            # only way to free one.  No deadlock: slots_per_bucket exceeds
            # max_inflight * batch_size, so the head batch's tasks are all
            # submitted, and tasks are taken first in, first out.
            self._flush_head()
        return self._free[bucket_id].popleft()

    def _flush_head(self) -> None:
        bucket, bucket_id, seqs, ids, short = self._inflight[0]
        with trace.span("shm_head_wait"):
            self._pump_until(lambda: all(s in self._results for s in seqs))
        self._inflight.popleft()
        examples = []
        slots = []
        for s in seqs:
            h, w, boxes, labels, scale = self._results.pop(s)
            b_id, slot = self._seq_slot.pop(s)
            slots.append(slot)
            examples.append((self._views[b_id][slot, :h, :w], boxes, labels, scale))
        # assemble copies the views into a new batch, so the slots recycle
        # at once and the consumer never aliases the slab.
        with trace.span("shm_assemble"):
            batch = assemble(examples, ids, bucket, self._config.max_gt, self.stats)
        self._free[bucket_id].extend(slots)
        if short:
            batch = pad_batch(batch, self._config.batch_size)
        if trace.enabled():
            trace.counter("shm.out_qsize", self._out.qsize())
            trace.counter("shm.inflight_batches", len(self._inflight))
        if self._hb is not None:
            self._hb.idle()  # a full output queue is backpressure, not a stall
        ok = self._put(batch)
        if self._hb is not None:
            self._hb.beat()
        if not ok:
            raise _StopRequested

    def _produce(self) -> None:
        config, train = self._config, self._train
        epoch = 0
        # The thread path's plan-level resume skip, so both streams agree.
        to_skip = config.skip_batches if train else 0
        while not self._stop.is_set():
            for bucket, chunk, ids, short in batch_plans(self._dataset, config, train, epoch):
                if to_skip > 0:
                    to_skip -= 1
                    continue
                bucket_id = self._bucket_ids[bucket]
                seqs = []
                for i in chunk:
                    slot = self._acquire_slot(bucket_id)
                    seq = self._next_seq
                    self._next_seq += 1
                    self._seq_slot[seq] = (bucket_id, slot)
                    seqs.append(seq)
                    self._task_q.put((seq, epoch, int(i), bucket_id, slot))
                self._inflight.append((bucket, bucket_id, seqs, ids, short))
                while len(self._inflight) >= self._max_inflight:
                    self._flush_head()
            if not train:
                while self._inflight:
                    self._flush_head()
                self._put(_SENTINEL)
                return
            epoch += 1

    def _cleanup(self) -> None:
        _cleanup_resources(self._mp_stop, self.processes, self._task_q, self._result_q,
                           self._shms, self._views)

    def _producer(self) -> None:
        # One heartbeat covers the coordinator and the workers: it beats on
        # every worker result and every delivered batch.
        self._hb = watchdog.register(
            "shm-pipe-coordinator",
            details=lambda: {
                "out_qsize": self._out.qsize(),
                "inflight_batches": len(self._inflight),
                "pending_results": len(self._results),
                "workers_alive": sum(p.is_alive() for p in self.processes),
            },
        )
        try:
            self._produce()
        except _StopRequested:
            pass
        except BaseException as exc:
            # Clean up FIRST, so that when the consumer sees the exception the
            # children are reaped and /dev/shm is clean.  Not the finalizer:
            # it sets the stop flag, and the stop-gated put must still deliver
            # this exception to a live consumer.
            self._cleanup()
            self._put(exc)
            return
        finally:
            self._hb.close()  # a closed pipeline must not look stalled
        self._cleanup()


def build_shm_pipeline(dataset, config: PipelineConfig, train: bool = True) -> _ShmPipeline:
    """The multiprocess twin of ``pipeline.build_pipeline`` (its target when
    ``config.num_worker_procs > 0``): the same batches in the same order,
    decoded by processes instead of threads."""
    return _ShmPipeline(dataset, config, train)
