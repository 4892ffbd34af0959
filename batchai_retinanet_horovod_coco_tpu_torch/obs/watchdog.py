"""Stall watchdog: a heartbeat registry for every long-lived thread; a
copy of the JAX package's ``obs/watchdog.py``.

When one of the concurrent machines (the decode pool's producer, the
device-prefetch thread, the eval consumer, the async eval, the checkpoint
writer, the serve threads) wedges, the watchdog turns a silently hung run
into an attributable diagnosis: which component stopped heartbeating, for
how long, what every other component was doing (last beat + its own
details: queue depths, in-flight counts), and a ``faulthandler`` dump of
every Python thread's stack.

Contract:

- ``register(name)`` → a ``Heartbeat``; the component calls ``beat()`` on
  every unit of progress (one attribute store — safe on any hot path) and
  ``close()`` on exit.  Names are uniquified (``name#2``) so repeated
  evals re-registering the same component never collide.
- ``beat()`` also re-arms the stall detector; one stall produces ONE dump
  until the component beats again (no log spam while wedged).
- ``idle()`` marks a component as legitimately quiescent (blocked on
  backpressure — a full output queue — or waiting between evals); idle
  components are listed in diagnoses but never flagged.  The next
  ``beat()`` clears it.
- The watchdog only OBSERVES.  It never kills anything: the existing
  timeouts remain the executioners; the watchdog's job is that when they
  fire, the post-mortem is already on disk.
- Registration is always allowed and costs one dict insert; the poll
  thread only exists between ``start()``/``stop()`` — an un-started
  watchdog is a passive registry with nil overhead.
"""

from __future__ import annotations

import faulthandler
import json
import sys
import threading
from typing import Any, Callable

from batchai_retinanet_horovod_coco_tpu_torch.obs import trace
from batchai_retinanet_horovod_coco_tpu_torch.obs.trace import monotonic_s
from batchai_retinanet_horovod_coco_tpu_torch.utils.locks import make_lock


class _Component:
    __slots__ = ("name", "stall_after", "details", "last_beat", "idle", "warned")

    def __init__(
        self,
        name: str,
        stall_after: float | None,
        details: Callable[[], dict] | None,
    ):
        self.name = name
        self.stall_after = stall_after  # None = watchdog default
        self.details = details
        self.last_beat = monotonic_s()
        self.idle = False
        self.warned = False


class Heartbeat:
    """The component-side handle.  ``beat()`` is one float store + two bool
    stores — call it as often as you like."""

    __slots__ = ("_c", "_registry")

    def __init__(self, component: _Component, registry: "Watchdog"):
        self._c = component
        self._registry = registry

    def beat(self) -> None:
        c = self._c
        c.last_beat = monotonic_s()
        c.idle = False
        c.warned = False

    def idle(self) -> None:
        """Declare legitimate quiescence (backpressure/waiting): skipped by
        the stall check until the next ``beat()``."""
        self._c.idle = True

    def close(self) -> None:
        self._registry._unregister(self._c)

    @property
    def name(self) -> str:
        return self._c.name


class Watchdog:
    """The registry + (optional) poll thread.  Module-level helpers below
    proxy a process-wide default instance; tests construct their own."""

    def __init__(
        self,
        stall_after: float = 120.0,
        poll_interval: float = 5.0,
        dump_path: str | None = None,
        on_stall: Callable[[dict], None] | None = None,
        sink: Any | None = None,
    ):
        self.stall_after = stall_after
        self.poll_interval = poll_interval
        self.dump_path = dump_path
        self.on_stall = on_stall
        self.sink = sink  # an obs.events.EventSink (or None)
        self._lock = make_lock("obs.watchdog.Watchdog._lock")
        self._components: dict[str, _Component] = {}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ---- registry --------------------------------------------------------

    def register(
        self,
        name: str,
        stall_after: float | None = None,
        details: Callable[[], dict] | None = None,
    ) -> Heartbeat:
        with self._lock:
            unique = name
            n = 2
            while unique in self._components:
                unique = f"{name}#{n}"
                n += 1
            c = _Component(unique, stall_after, details)
            self._components[unique] = c
        return Heartbeat(c, self)

    def _unregister(self, c: _Component) -> None:
        with self._lock:
            self._components.pop(c.name, None)

    def components(self) -> dict[str, float]:
        """name → seconds since last beat (diagnostics/tests)."""
        now = monotonic_s()
        with self._lock:
            return {n: now - c.last_beat for n, c in self._components.items()}

    def stalled_components(self, now: float | None = None) -> list[dict]:
        """READ-ONLY stall probe (the telemetry /healthz verdict,
        obs/telemetry.py): every non-idle component currently past its
        stall budget, most-stalled first.  Unlike ``check_once`` it never
        touches the one-dump-per-stall ``warned`` latch — a health scrape
        must not eat the poll thread's diagnosis."""
        now = monotonic_s() if now is None else now
        with self._lock:
            comps = list(self._components.values())
        out = []
        for c in comps:
            if c.idle:
                continue
            budget = c.stall_after or self.stall_after
            age = now - c.last_beat
            if age > budget:
                out.append(
                    {
                        "component": c.name,
                        "stalled_for_s": round(age, 3),
                        "stall_after_s": budget,
                    }
                )
        out.sort(key=lambda d: (-d["stalled_for_s"], d["component"]))
        return out

    # ---- stall detection -------------------------------------------------

    def _snapshot(self, now: float) -> list[dict]:
        with self._lock:
            comps = list(self._components.values())
        snap = []
        for c in comps:
            details = None
            if c.details is not None:
                try:
                    details = c.details()
                except Exception as e:  # a dead component's gauge must not
                    details = {"details_error": repr(e)}  # kill the dump
            snap.append(
                {
                    "name": c.name,
                    "age_s": round(now - c.last_beat, 3),
                    "idle": c.idle,
                    "stall_after_s": c.stall_after or self.stall_after,
                    "details": details,
                }
            )
        return snap

    def check_once(self, now: float | None = None) -> dict | None:
        """One poll: returns a diagnosis dict if any non-idle component
        exceeded its stall budget (the most-stalled one is named as THE
        component), else None.  Injectable ``now`` makes this testable
        without sleeping."""
        now = monotonic_s() if now is None else now
        stalled: _Component | None = None
        stalled_over = 0.0
        with self._lock:
            comps = list(self._components.values())
        for c in comps:
            if c.idle or c.warned:
                continue
            budget = c.stall_after or self.stall_after
            over = (now - c.last_beat) - budget
            if over > 0 and over > stalled_over:
                stalled, stalled_over = c, over
        if stalled is None:
            return None
        stalled.warned = True  # one dump per stall; re-armed by beat()
        return {
            "component": stalled.name,
            "stalled_for_s": round(now - stalled.last_beat, 3),
            "stall_after_s": stalled.stall_after or self.stall_after,
            "components": self._snapshot(now),
            "alive_threads": sorted(
                t.name for t in threading.enumerate()
            ),
        }

    def _dump(self, diag: dict) -> None:
        # Perfetto marker: the stall is visible ON the
        # timeline at the instant it fired — lined up against whatever the
        # other tracks were (not) doing — instead of only in the JSONL
        # record and watchdog_stacks.txt.  No-op while tracing is off.
        trace.instant(
            "stall",
            component=diag["component"],
            stalled_for_s=diag["stalled_for_s"],
        )
        line = json.dumps({"event": "watchdog_stall", **diag})
        print(line, file=sys.stderr, flush=True)
        if self.dump_path:
            try:
                with open(self.dump_path, "a") as f:
                    f.write(line + "\n== thread stacks ==\n")
                    faulthandler.dump_traceback(file=f)
                    f.write("\n")
            except OSError:
                faulthandler.dump_traceback(file=sys.stderr)
        else:
            faulthandler.dump_traceback(file=sys.stderr)
        if self.sink is not None:
            try:
                self.sink.event("watchdog_stall", **diag)
            except Exception:
                pass  # a broken sink must not mask the stderr dump
        if self.on_stall is not None:
            self.on_stall(diag)

    # ---- poll thread -----------------------------------------------------

    def _run(self) -> None:
        try:
            while not self._stop.wait(self.poll_interval):
                diag = self.check_once()
                if diag is not None:
                    self._dump(diag)
        except BaseException as e:
            # The monitor must never die silently: a crashed poll thread
            # disarms stall diagnosis for the rest of the run, so announce
            # the disarm loudly before the thread ends.
            print(
                json.dumps({"event": "watchdog_crashed", "error": repr(e)}),
                file=sys.stderr, flush=True,
            )
            raise

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = threading.Event()
        # watchdog: the watchdog's own poll thread — it IS the monitor.
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="obs-watchdog"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---- process-wide default instance --------------------------------------

_default = Watchdog()


def default() -> Watchdog:
    return _default


def register(
    name: str,
    stall_after: float | None = None,
    details: Callable[[], dict] | None = None,
) -> Heartbeat:
    """Register with the process-wide watchdog (always allowed; the poll
    thread may or may not be running — registration is just bookkeeping)."""
    return _default.register(name, stall_after=stall_after, details=details)


def start(
    stall_after: float | None = None,
    poll_interval: float | None = None,
    dump_path: str | None = None,
    sink: Any | None = None,
    on_stall: Callable[[dict], None] | None = None,
) -> Watchdog:
    """(Re)configure and start the default watchdog's poll thread."""
    if stall_after is not None:
        _default.stall_after = stall_after
    if poll_interval is not None:
        _default.poll_interval = poll_interval
    if dump_path is not None:
        _default.dump_path = dump_path
    if sink is not None:
        _default.sink = sink
    if on_stall is not None:
        _default.on_stall = on_stall
    _default.start()
    return _default


def stop() -> None:
    _default.stop()
