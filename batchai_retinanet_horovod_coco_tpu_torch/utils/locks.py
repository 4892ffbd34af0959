"""Runtime lock-order witness — stdlib only; a copy of the JAX package's
``utils/locks.py``.

The committed may-hold-while-acquiring order of the port's named locks is
``lock_order.json`` beside this package's ``__init__.py`` (the JAX
package's order file is its own and never read here).  Under
``RETINANET_LOCK_DEBUG=1`` (the test suite sets it),
``make_lock("<identity>")`` returns a debug wrapper that records each
thread's real acquisition order and RAISES ``LockOrderViolation`` on any
inversion of the committed order.

With the flag off, ``make_lock``/``make_rlock`` return plain
``threading.Lock``/``RLock`` objects: the witness is identity and costs
nothing.

Semantics when enabled:

- Acquiring ``B`` while holding ``A`` raises iff the committed order
  contains the REVERSE edge ``B -> A`` (i.e. the tree's sanctioned order
  says B-before-A).  Pairs absent from the committed order are recorded
  (``observed_edges()``) but never raise — review, not the witness,
  decides whether a new edge is acceptable.
- Re-entrant acquisition of a lock already held by this thread (RLock
  reentry, ``Condition._is_owned`` probes) is never checked.
- Identities are the ``make_lock`` name literals
  (``obs.watchdog.Watchdog._lock``): the dotted path of the lock inside
  the package.
"""

from __future__ import annotations

import json
import os
import threading

ENV_FLAG = "RETINANET_LOCK_DEBUG"
#: Override the committed-order file (tests / fixture trees).
ENV_ORDER = "RETINANET_LOCK_ORDER"


class LockOrderViolation(RuntimeError):
    """A thread acquired locks against the committed order."""


def enabled() -> bool:
    return os.environ.get(ENV_FLAG, "") == "1"


def default_order_path() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(pkg, "lock_order.json")


_state_lock = threading.Lock()
_committed: set[tuple[str, str]] | None = None  # (src held, dst acquired)
_observed: set[tuple[str, str]] = set()
_tls = threading.local()


def _committed_edges() -> set[tuple[str, str]]:
    global _committed
    with _state_lock:
        if _committed is None:
            path = os.environ.get(ENV_ORDER) or default_order_path()
            edges: set[tuple[str, str]] = set()
            if os.path.exists(path):
                with open(path) as f:
                    data = json.load(f)
                edges = {(e["src"], e["dst"])
                         for e in data.get("edges", [])}
            _committed = edges
        return _committed


def _set_committed_for_testing(
        edges: set[tuple[str, str]] | None) -> None:
    """Tests inject a committed order without touching the filesystem;
    pass None to reload from disk on next use."""
    global _committed
    with _state_lock:
        _committed = set(edges) if edges is not None else None


def observed_edges() -> list[tuple[str, str]]:
    """Every (held, acquired) pair actually witnessed so far."""
    with _state_lock:
        return sorted(_observed)


def reset_observed() -> None:
    with _state_lock:
        _observed.clear()


def _held_stack() -> list[str]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _check_order(name: str) -> None:
    held = _held_stack()
    if not held or name in held:
        return
    committed = _committed_edges()
    new_pairs = [(h, name) for h in held]
    for h, n in new_pairs:
        if (n, h) in committed:
            chain = " -> ".join(held + [name])
            raise LockOrderViolation(
                f"lock-order inversion: thread "
                f"{threading.current_thread().name!r} acquiring {name!r} "
                f"while holding {h!r}; its chain is [{chain}] but the "
                f"committed order (lock_order.json) has the "
                f"chain {name!r} -> {h!r} ({name!r} before {h!r}). "
                f"Fix the acquisition order, or change the committed "
                f"order after review."
            )
    with _state_lock:
        _observed.update(new_pairs)


class _DebugLockBase:
    """Shared acquire/release bookkeeping for the Lock/RLock wrappers."""

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _check_order(self.name)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _held_stack().append(self.name)
        return ok

    def release(self) -> None:
        held = _held_stack()
        # Pop the LAST occurrence: RLock reentry releases innermost-first.
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} of {self._inner!r}>"


class DebugLock(_DebugLockBase):
    pass


class DebugRLock(_DebugLockBase):
    # threading.Condition duck-types on these when given a custom lock.
    def _release_save(self):
        return self._inner._release_save()  # pragma: no cover

    def _acquire_restore(self, state):  # pragma: no cover
        return self._inner._acquire_restore(state)

    def _is_owned(self):  # pragma: no cover
        return self._inner._is_owned()


def make_lock(name: str):
    """A ``threading.Lock`` — wrapped by the order witness when
    ``RETINANET_LOCK_DEBUG=1``.  ``name`` is the dotted lock identity the
    committed order uses (``serve.frontend.DetectionServer._lock``)."""
    if enabled():
        return DebugLock(name, threading.Lock())
    return threading.Lock()


def make_rlock(name: str):
    """``make_lock`` for re-entrant locks."""
    if enabled():
        return DebugRLock(name, threading.RLock())
    return threading.RLock()
