"""Seeded open-loop arrival schedules; a copy of the JAX package's
``utils/arrivals.py``.

The mixed steady → burst → lull schedule, the diurnal + spike schedule an
autoscaler must follow, and per-stream video frame traces.  Pure NumPy, no
serve imports: the same seed gives a byte-identical schedule, in this
package and in the JAX package.
"""

from __future__ import annotations

import numpy as np

#: The canonical phase multipliers: steady → burst → lull, cycling.
MIXED_PHASES = (1.0, 1.8, 0.7)


def mixed_arrival_schedule(
    n: int,
    base_rate: float,
    seed: int = 0,
    phases: tuple[float, ...] = MIXED_PHASES,
) -> list[float]:
    """Seeded open-loop MIXED arrival times (absolute seconds): cycling
    steady → burst → lull phases of exponential inter-arrivals — the load
    shape that exposes deadline-only partial-batch waste.  Same seed ⇒
    same offered load, so two legs race the identical schedule."""
    rng = np.random.default_rng(seed)
    phase_len = max(1, n // 6)
    t, times = 0.0, []
    for i in range(n):
        rate = base_rate * phases[(i // phase_len) % len(phases)]
        t += float(rng.exponential(1.0 / rate))
        times.append(t)
    return times


#: One spike window per period: (center_frac, width_frac, multiplier).
DIURNAL_SPIKES = ((0.5, 0.15, 3.0),)


def diurnal_spike_schedule(
    n: int,
    base_rate: float,
    seed: int = 0,
    period_s: float = 60.0,
    amplitude: float = 0.5,
    spikes: tuple[tuple[float, float, float], ...] = DIURNAL_SPIKES,
) -> list[float]:
    """Seeded diurnal + spike open-loop arrival times — the load shape an
    autoscaler must follow: a sinusoidal base rate (one cycle per
    ``period_s``) with multiplicative burst windows riding on it.
    ``spikes`` are per-period windows ``(center_frac, width_frac,
    multiplier)`` in period-fraction units; ``amplitude < 1`` keeps the
    off-peak rate positive so the schedule always terminates."""
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    rng = np.random.default_rng(seed)
    t, times = 0.0, []
    for _ in range(n):
        frac = (t % period_s) / period_s
        rate = base_rate * (1.0 + amplitude * np.sin(2.0 * np.pi * frac))
        for center, width, mult in spikes:
            # Wrap-aware distance on the unit circle of the period.
            d = abs(frac - center)
            if min(d, 1.0 - d) <= width / 2.0:
                rate *= mult
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        times.append(t)
    return times


def multi_stream_schedule(
    n_streams: int,
    frames_per_stream: int,
    fps: float,
    seed: int = 0,
    jitter: float = 0.25,
) -> list[list[float]]:
    """Per-stream frame arrival times for ``n_streams`` concurrent video
    sessions (absolute seconds, one sorted list per stream).

    Video is NOT Poisson: frames tick at ~``fps`` with bounded capture
    jitter, and streams start staggered (stream k opens k/fps seconds in).
    The whole multi-stream trace is a pure function of ``seed``."""
    rng = np.random.default_rng(seed)
    period = 1.0 / max(1e-9, fps)
    streams = []
    for k in range(n_streams):
        start = k * period / max(1, n_streams)
        offsets = rng.uniform(
            -jitter * period, jitter * period, size=frames_per_stream
        )
        times = [
            max(0.0, start + i * period + float(offsets[i]))
            for i in range(frames_per_stream)
        ]
        # Capture jitter must never reorder frames: a video client sends
        # frame i before frame i+1 by construction.
        times.sort()
        streams.append(times)
    return streams


__all__ = [
    "DIURNAL_SPIKES",
    "MIXED_PHASES",
    "diurnal_spike_schedule",
    "mixed_arrival_schedule",
    "multi_stream_schedule",
]
