"""Bounded retry/backoff policy; a copy of the JAX package's
``utils/backoff.py``.

Bounded attempts, a geometric (or explicitly listed) delay schedule with a
ceiling, and *deterministic-seeded* jitter, so that two processes never
thundering-herd a recovering dependency while a test can still pin the
exact schedule.  Consumers:

- the fleet router's circuit-breaker half-open probe cadence
  (``serve/fleet.py``): the policy is *consulted* for delays against an
  injectable clock, never slept on, so the breaker state machine is
  testable without wall time;
- the fleet command line's respawn budget (``serve/replica.py::
  RespawnBudget``) and the health wait of a spawned replica
  (``spawn_http_replica``).

The policy object is frozen and stateless: ``delay_s(attempt)`` is a pure
function of (policy, attempt), so the full schedule is reproducible from
the seed alone (``delays()`` returns it whole), and equal to the JAX
package's for the same policy.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Sequence


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Bounded-retry schedule: ``max_tries`` attempts, ``max_tries - 1``
    sleeps between them.

    Delay for attempt ``i`` (0-based, i.e. the sleep AFTER the i-th
    failure) is ``min(ceiling_s, base_s * multiplier**i)`` — or
    ``schedule[min(i, len-1)]`` when an explicit ``schedule`` overrides
    the geometric rule (last value reused past the end).  ``jitter`` then
    scales it by a uniform factor in ``[1 - jitter, 1 + jitter]`` drawn
    from a per-(seed, attempt) RNG, so the schedule is deterministic given
    the seed but decorrelated across seeds (replicas seed from their id).
    """

    max_tries: int = 3
    base_s: float = 0.5
    multiplier: float = 2.0
    ceiling_s: float = 30.0
    jitter: float = 0.0  # ± fraction of the pre-jitter delay
    seed: int = 0
    schedule: tuple[float, ...] | None = None  # explicit delays override

    def __post_init__(self):
        if self.max_tries < 1:
            raise ValueError(f"max_tries must be >= 1, got {self.max_tries}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        if self.schedule is not None and not self.schedule:
            raise ValueError("explicit schedule must be non-empty")

    def delay_s(self, attempt: int) -> float:
        """The sleep after the ``attempt``-th failure (0-based).  Pure:
        the same (policy, attempt) always yields the same delay."""
        attempt = max(0, int(attempt))
        if self.schedule is not None:
            d = float(self.schedule[min(attempt, len(self.schedule) - 1)])
        elif self.multiplier <= 1.0 or self.base_s <= 0.0:
            d = min(self.ceiling_s, self.base_s * self.multiplier**attempt)
        else:
            # Growing schedules multiply ITERATIVELY, stopping at the
            # ceiling: the closed form ``base * multiplier**attempt``
            # overflows a float near attempt ~1024, and long-lived
            # consumers (the fleet breaker's open counter against a
            # permanently dead replica) legitimately reach that.
            d = self.base_s
            left = attempt
            while d < self.ceiling_s and left > 0:
                d *= self.multiplier
                left -= 1
            d = min(d, self.ceiling_s)
        if self.jitter > 0.0:
            # Deterministic per-(seed, attempt): reproducible schedules,
            # decorrelated across seeds.  The mixing constant keeps
            # adjacent seeds apart.
            rng = random.Random(self.seed * 1_000_003 + attempt)
            d *= 1.0 + self.jitter * rng.uniform(-1.0, 1.0)
        return max(0.0, d)

    def delays(self) -> list[float]:
        """The whole between-attempt schedule (``max_tries - 1`` sleeps)."""
        return [self.delay_s(i) for i in range(self.max_tries - 1)]

    def retry(
        self,
        fn: Callable[[], object],
        ok: Callable[[object], bool] = lambda r: r is None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> tuple[int, object]:
        """Call ``fn`` up to ``max_tries`` times, sleeping the schedule
        between failures; returns ``(attempts_used, last_result)``.

        ``ok(result)`` decides success (default: None means reachable,
        anything else is the error).  Exceptions propagate immediately:
        wrap the callable if exceptions should count as failures.
        """
        last: object = None
        for i in range(self.max_tries):
            last = fn()
            if ok(last):
                return i + 1, last
            if i + 1 < self.max_tries:
                sleep(self.delay_s(i))
        return self.max_tries, last

    @classmethod
    def from_env_schedule(
        cls, attempts: int, schedule_csv: str, default: Sequence[float] = (10.0,)
    ) -> "BackoffPolicy":
        """An attempt count plus a comma list of seconds ("10,30"), last
        value reused; no jitter."""
        parsed = tuple(
            float(x) for x in schedule_csv.split(",") if x.strip()
        ) or tuple(default)
        return cls(max_tries=max(1, attempts), schedule=parsed)


__all__ = ["BackoffPolicy"]
