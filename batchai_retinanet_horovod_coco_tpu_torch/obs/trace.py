"""Low-overhead structured trace spans → Chrome ``trace_event`` JSON; a
copy of the JAX package's ``obs/trace.py``.

The training and serving paths run concurrent machines (the decode pool's
producer, the device-prefetch thread, the eval consumer, the async eval,
the checkpoint writer, the serve router, batchers and dispatcher) whose
interleaving decides whether the card is fed.  This module records *where
the time went*: named spans, ring-buffered per thread, exported as Chrome
``trace_event`` JSON that Perfetto/``chrome://tracing`` renders as one
aligned timeline with a track per thread and a process group per OS
process.

Design constraints, in priority order:

1. **Nil disabled-path overhead.**  ``span()`` checks one module-level bool
   and returns a shared no-op context manager; no allocation, no clock
   read, no lock.  The hot step loop keeps its spans unconditionally.
2. **Stdlib only.**  No torch import: anything needing the device
   (device metadata, memory) lives in ``obs.events``, which never
   initialises CUDA itself.
3. **Lock-free recording.**  Each thread appends to its own bounded
   ``deque`` (the ring); the global registry lock is taken only at ring
   creation and export.  A full ring drops the OLDEST events (the tail of
   a run is what a stall post-mortem needs).

Clock contract (the ONE clock): ``monotonic_s()`` is the
timestamp source for spans AND for the JSONL event sink (obs/events.py), so
trace and metrics timestamps align exactly.  For cross-process alignment the
exporter maps monotonic times onto the wall clock via a (wall, perf) anchor
pair captured at import — processes on one host share ``time.time()``, so
worker tracks line up with the main loop's without a handshake.

Cross-thread/cross-process spans: ``begin()`` returns a handle that any
thread may ``end()`` (the span lands on the *beginning* thread's track —
e.g. a batch's life from submit to assembly).  Cross-process spans are just
each process recording its own complete spans; ``merge_traces`` stitches
the per-process JSON files (each worker exports its own on clean exit) into
one ``trace.json``.

Child-process propagation: ``configure()`` exports ``RETINANET_OBS_DIR`` so
spawned children can self-enable via ``maybe_configure_from_env()``
without widening any pickled config surface.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import uuid
from typing import Any, Iterator

# Env var contract shared with spawned children: presence = tracing on,
# value = the trace/artifact directory.
OBS_DIR_ENV = "RETINANET_OBS_DIR"
# Best-effort process index for multi-process merges (children inherit
# whatever the parent had resolved).
OBS_PINDEX_ENV = "RETINANET_OBS_PINDEX"
# The run id scoping this run's per-process trace files: pids are never
# reused within a run but ARE across runs, so without a run token a
# reused --obs-dir would merge stale partials from previous runs into
# trace.json.  Children inherit the parent's id via this env var.
OBS_RUN_ENV = "RETINANET_OBS_RUN"

# Request tracing: a client (or a fleet frontend) sends a trace id in this
# HTTP header; the serve frontend tags the request's ``serve_request`` span
# (and its flow marker) with it and echoes it back on the response, so one
# slow request is followable across the merged trace's tracks.
TRACE_HEADER = "X-Retinanet-Trace"

DEFAULT_CAPACITY = 65536

# (wall, perf) anchor pair: monotonic_s() times map onto the shared wall
# clock as  wall = _WALL_ANCHOR + (t - _PERF_ANCHOR).  Captured once at
# import so every ring in this process shares one mapping.
_WALL_ANCHOR = time.time()  # lint: monotonic-clock: the wall half of the anchor — wall time IS the point here
_PERF_ANCHOR = time.perf_counter()  # lint: monotonic-clock: the perf half of the anchor monotonic_s() maps through

_enabled = False
_trace_dir: str | None = None
_capacity = DEFAULT_CAPACITY
_process_label = "main"
_run_id: str | None = None
_config_pid: int | None = None  # which process this config belongs to

_registry_lock = threading.Lock()
_rings: list["_Ring"] = []
_tls = threading.local()


def monotonic_s() -> float:
    """THE timestamp source for the whole obs subsystem (spans, JSONL
    events, watchdog heartbeats): monotonic, sub-µs resolution, immune to
    wall-clock steps.  Use this instead of ``time.time()`` /
    ``time.perf_counter()`` in instrumented code so every timestamp in a
    run is mutually comparable."""
    # lint: monotonic-clock: this IS the one clock's implementation
    return time.perf_counter()


def to_wall(t: float) -> float:
    """Map a ``monotonic_s()`` timestamp onto the wall clock (seconds since
    epoch) — the exporter's cross-process alignment."""
    return _WALL_ANCHOR + (t - _PERF_ANCHOR)


def enabled() -> bool:
    return _enabled


# Synthetic per-ring track ids: OS thread idents RECYCLE (a dead eval
# pipeline's coordinator and a later prefetch thread can share an ident),
# which would interleave two different threads' spans on one Perfetto
# track.  A ring is per thread LIFETIME (thread-local), so a fresh id per
# ring keeps every thread's spans on its own track.
_next_tid = 1
# Bumped by reset(): a thread whose thread-local ring predates the last
# reset would otherwise keep appending to a ring no longer in the
# registry — every event silently lost.  _ring() re-registers instead.
_generation = 0


class _Ring:
    """One thread's bounded event buffer.  Events are tuples
    ``(ph, name, t_s, dur_s_or_value, args_or_None)`` with ``ph`` the
    Chrome phase ("X" complete, "i" instant, "C" counter, "s"/"t"/"f"
    flow start/step/end)."""

    __slots__ = ("events", "tid", "thread_name", "appended", "gen")

    def __init__(self, capacity: int):
        global _next_tid
        self.events: collections.deque = collections.deque(maxlen=capacity)
        with _registry_lock:
            self.tid = _next_tid
            _next_tid += 1
        t = threading.current_thread()
        self.thread_name = t.name
        self.appended = 0
        self.gen = _generation

    def add(self, ev: tuple) -> None:
        self.appended += 1
        self.events.append(ev)

    @property
    def dropped(self) -> int:
        return self.appended - len(self.events)


# Bound on distinct per-thread rings (= Perfetto tracks): request-scoped
# spans on thread-per-request HTTP handler threads (the serve/fleet
# frontends) would otherwise register one permanent ring per REQUEST for
# the life of the process.  Threads beyond the cap share one overflow
# ring — deque.append is GIL-atomic, so the only degradation is that
# their spans merge onto a single labeled track instead of growing
# memory without bound.
MAX_RINGS = 4096
_overflow_ring: "_Ring | None" = None


def _ring() -> _Ring:
    r = getattr(_tls, "ring", None)
    if r is None or r.gen != _generation:  # stale after a reset()
        global _overflow_ring
        with _registry_lock:
            at_cap = len(_rings) >= MAX_RINGS
        if at_cap:
            r = _overflow_ring
            if r is None or r.gen != _generation:
                r = _Ring(_capacity)
                r.thread_name = "overflow (ring cap)"
                with _registry_lock:
                    _rings.append(r)
                _overflow_ring = r
            _tls.ring = r
        else:
            r = _tls.ring = _Ring(_capacity)
            with _registry_lock:
                _rings.append(r)
    return r


class _NullSpan:
    """The shared disabled-path span: no state, no clock, no allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "t0")

    def __init__(self, name: str, args: dict | None):
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = monotonic_s()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = monotonic_s()
        _ring().add(("X", self.name, self.t0, t1 - self.t0, self.args))
        return False


def span(name: str, **args: Any):
    """Context manager timing a named region on the current thread's track.

    Disabled: returns the shared no-op singleton (one bool check).  Keyword
    args become the Chrome event's ``args`` payload — avoid them on
    per-step hot paths (the dict is built before the enabled check)."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, args or None)


def begin(name: str, **args: Any):
    """Explicit begin half of a cross-thread span: the returned handle may
    be ``end()``-ed by ANY thread; the span lands on the beginning thread's
    track.  Returns None when disabled (``end(None)`` is a no-op)."""
    if not _enabled:
        return None
    return (name, monotonic_s(), _ring(), args or None)


def end(handle) -> None:
    """Complete a ``begin()`` handle (any thread)."""
    if handle is None or not _enabled:
        return
    name, t0, ring, args = handle
    ring.add(("X", name, t0, monotonic_s() - t0, args))


def instant(name: str, **args: Any) -> None:
    """A zero-duration marker event on the current thread's track."""
    if not _enabled:
        return
    _ring().add(("i", name, monotonic_s(), 0.0, args or None))


def counter(name: str, value: float) -> None:
    """A Chrome counter sample (queue depth, occupancy, bytes-in-use):
    renders as a stacked-area track in Perfetto."""
    if not _enabled:
        return
    _ring().add(("C", name, monotonic_s(), float(value), None))


def new_trace_id() -> str:
    """Mint one fleet-wide request trace id (the value carried in
    ``TRACE_HEADER`` and tagged onto every span the request touches)."""
    return uuid.uuid4().hex[:16]


def _flow(ph: str, name: str, flow_id) -> None:
    if not _enabled:
        return
    _ring().add((ph, name, monotonic_s(), 0.0, {"id": str(flow_id)}))


def flow_start(name: str, flow_id) -> None:
    """Begin a Chrome flow (the arrow Perfetto draws between slices on
    different tracks).  Emit INSIDE the slice the arrow should leave from
    (binding is by enclosing slice); ``flow_step``/``flow_end`` with the
    same (name, id) continue it on other threads/processes — the visual
    follow-the-request mechanism for fleet traces."""
    _flow("s", name, flow_id)


def flow_step(name: str, flow_id) -> None:
    _flow("t", name, flow_id)


def flow_end(name: str, flow_id) -> None:
    _flow("f", name, flow_id)


def configure(
    trace_dir: str,
    capacity: int = DEFAULT_CAPACITY,
    process_label: str = "main",
    export_env: bool = True,
) -> None:
    """Enable tracing process-wide.  ``export_env`` (default) publishes
    ``RETINANET_OBS_DIR`` + a fresh run id so spawned children self-enable — and export under the SAME run id — via
    ``maybe_configure_from_env``.  ``export_env=False`` (children) adopts
    the inherited run id instead of minting one."""
    global _enabled, _trace_dir, _capacity, _process_label, _run_id
    global _config_pid
    os.makedirs(trace_dir, exist_ok=True)
    _trace_dir = trace_dir
    _capacity = capacity
    _process_label = process_label
    _config_pid = os.getpid()
    if export_env:
        _run_id = uuid.uuid4().hex[:8]
        os.environ[OBS_DIR_ENV] = trace_dir
        os.environ[OBS_RUN_ENV] = _run_id
    else:
        _run_id = os.environ.get(OBS_RUN_ENV) or uuid.uuid4().hex[:8]
    _enabled = True


def run_id() -> str | None:
    """This run's trace-file scoping token (None until configured)."""
    return _run_id


def trace_dir() -> str | None:
    """The configured obs artifact directory (None while disabled) — the
    default landing spot for failure-path artifacts that belong next to
    the trace (the numerics NUMERICS_DUMP.json, train/loop.py)."""
    return _trace_dir if _enabled else None


def maybe_configure_from_env(process_label: str) -> bool:
    """Child-process bring-up: enable tracing iff the parent exported
    ``RETINANET_OBS_DIR`` before the spawn.  Never re-exports the env (the
    child inherited it already).

    FORK-started children inherit ``_enabled`` along with the parent's
    recorded rings; treating that as "already configured" would re-export
    every pre-fork parent span under the child's pid (duplicated on the
    merged timeline) with the parent's label.  The recorded config pid
    tells the cases apart: same pid = genuinely configured, different
    pid = inherited — drop the inherited rings and re-label."""
    if _enabled:
        if _config_pid == os.getpid():
            return True
        global _generation
        with _registry_lock:
            _rings.clear()  # the parent owns those events, not this child
            _generation += 1
    trace_dir = os.environ.get(OBS_DIR_ENV)
    if not trace_dir:
        return False
    configure(trace_dir, process_label=process_label, export_env=False)
    return True


def set_process_index(index: int) -> None:
    """Label this process's trace with its rank in a data-parallel world
    (``process_index=<rank>``, and ``p<rank>:`` before the process label);
    published in the obs env contract, so children started later inherit
    it."""
    os.environ[OBS_PINDEX_ENV] = str(int(index))


def _process_index() -> int | None:
    """The process index, with NO side effects: the env value that
    :func:`set_process_index` or a parent published (``OBS_PINDEX_ENV``;
    the run header sets it too).  None = unknown."""
    v = os.environ.get(OBS_PINDEX_ENV)
    if v is not None:
        try:
            return int(v)
        except ValueError:
            pass
    return None


def _chrome_events() -> Iterator[dict]:
    """This process's rings → Chrome trace_event dicts (ts/dur in µs on
    the shared wall timeline)."""
    pid = os.getpid()
    with _registry_lock:
        rings = list(_rings)
    pindex = _process_index()
    pname = f"p{pindex if pindex is not None else '?'}:{_process_label}"
    yield {
        "ph": "M", "name": "process_name", "pid": pid,
        "args": {"name": f"{pname} (pid {pid})"},
    }
    if pindex is not None:
        yield {
            "ph": "M", "name": "process_labels", "pid": pid,
            "args": {"labels": f"process_index={pindex}"},
        }
    for ring in rings:
        yield {
            "ph": "M", "name": "thread_name", "pid": pid, "tid": ring.tid,
            "args": {"name": ring.thread_name},
        }
        for ph, name, t, dur, args in list(ring.events):
            ts = int(to_wall(t) * 1e6)
            if ph == "X":
                ev = {
                    "ph": "X", "cat": "obs", "name": name, "ts": ts,
                    "dur": max(0, int(dur * 1e6)), "pid": pid,
                    "tid": ring.tid,
                }
                if args:
                    ev["args"] = args
            elif ph == "C":
                ev = {
                    "ph": "C", "cat": "obs", "name": name, "ts": ts,
                    "pid": pid, "tid": ring.tid, "args": {"value": dur},
                }
            elif ph in ("s", "t", "f"):
                # Flow events: same (cat, name, id) across processes link
                # into one Perfetto arrow chain; "bp": "e" binds each to
                # its enclosing slice on this track.
                ev = {
                    "ph": ph, "cat": "obs.flow", "name": name, "ts": ts,
                    "pid": pid, "tid": ring.tid,
                    "id": (args or {}).get("id"), "bp": "e",
                }
            else:
                ev = {
                    "ph": "i", "cat": "obs", "name": name, "ts": ts,
                    "s": "t", "pid": pid, "tid": ring.tid,
                }
                if args:
                    ev["args"] = args
            yield ev


def snapshot_events() -> list[dict]:
    """This process's recorded events as Chrome ``trace_event`` dicts —
    the export payload without the file.  The inline analysis hooks
    read the live rings through this; empty while tracing is disabled."""
    if not _enabled:
        return []
    return list(_chrome_events())


def export(path: str | None = None) -> str | None:
    """Write this process's events as one Chrome-trace JSON file.

    Default path: ``<trace_dir>/trace-<label>-<pid>.json`` — per-process
    names so concurrent exporters never clobber.  Returns the
    path written, or None when tracing is disabled."""
    if not _enabled:
        return None
    if path is None:
        assert _trace_dir is not None
        path = os.path.join(
            _trace_dir,
            f"trace-{_run_id}-{_process_label}-{os.getpid()}.json",
        )
    dropped = sum(r.dropped for r in _rings)
    doc = {
        "traceEvents": snapshot_events(),
        "displayTimeUnit": "ms",
        "otherData": {
            "process_label": _process_label,
            "pid": os.getpid(),
            "events_dropped_by_ring": dropped,
            "wall_anchor_s": _WALL_ANCHOR,
        },
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)  # merge never reads a half-written file
    return path


def merge_traces(
    trace_dir: str | None = None, out_name: str = "trace.json"
) -> str | None:
    """Stitch THIS RUN's per-process ``trace-<run_id>-*.json`` files in
    ``trace_dir`` into one Perfetto-loadable file.  Scoped by run id: a
    reused obs dir keeps previous runs' partials on disk, and merging
    them would put hours-old spans on the wall-aligned timeline.  Call
    AFTER the pipelines closed (workers export on clean exit, and close()
    joins them first).  Unreadable partials are skipped with a note in
    ``otherData`` rather than failing the merge."""
    trace_dir = trace_dir or _trace_dir
    if trace_dir is None:
        return None
    prefix = f"trace-{_run_id}-" if _run_id else "trace-"
    events: list[dict] = []
    merged_from: list[str] = []
    skipped: list[str] = []
    for name in sorted(os.listdir(trace_dir)):
        if not (name.startswith(prefix) and name.endswith(".json")):
            continue
        p = os.path.join(trace_dir, name)
        try:
            with open(p) as f:
                events.extend(json.load(f)["traceEvents"])
            merged_from.append(name)
        except (OSError, ValueError, KeyError):
            skipped.append(name)
    out = os.path.join(trace_dir, out_name)
    # Atomic like the per-process exports above: readers scan for
    # trace.json by name (utils.atomicio is stdlib-only — this module's
    # import contract holds).  STREAMED into
    # the tmp file: a long run's merged events are large, and a full
    # json.dumps string would double peak memory at finalize.
    from batchai_retinanet_horovod_coco_tpu_torch.utils.atomicio import (
        atomic_writer,
    )

    with atomic_writer(out) as f:
        json.dump(
            {
                "traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {
                    "merged_from": merged_from,
                    "skipped": skipped,
                },
            },
            f,
        )
    return out


def reset() -> None:
    """Test hook: disable and drop all recorded state (including the env
    contract, so a later test's spawned children don't self-enable)."""
    global _enabled, _trace_dir, _process_label, _capacity, _run_id
    _enabled = False
    _trace_dir = None
    _process_label = "main"
    _capacity = DEFAULT_CAPACITY
    _run_id = None
    os.environ.pop(OBS_DIR_ENV, None)
    os.environ.pop(OBS_PINDEX_ENV, None)
    os.environ.pop(OBS_RUN_ENV, None)
    global _generation, _overflow_ring
    _overflow_ring = None
    with _registry_lock:
        _rings.clear()
        # Invalidate EVERY thread's cached thread-local ring (not just the
        # caller's): a live thread's next event re-registers a fresh ring
        # instead of appending to an orphaned one.
        _generation += 1
