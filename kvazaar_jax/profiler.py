"""Tracing / profiling helpers (SURVEY §5: the reference exposes
KVZ_GET_TIME wall/CPU timing macros, per-frame CLI stats, and a
threadqueue Gantt tool; the equivalents here are per-phase wall
accumulators plus the JAX device profiler).

Usage:
    from kvazaar_jax.profiler import phases, phase, device_trace
    with phase("search"):
        ...
    print(phases.report())

    with device_trace("/tmp/trace"):     # XPlane dump for xprof /
        encode(...)                      # TensorBoard's profile tab
"""

from __future__ import annotations

import contextlib
import threading
import time


class PhaseTimers:
    """Thread-safe named wall-time accumulators."""

    def __init__(self):
        self._lock = threading.Lock()
        self._acc: dict = {}

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        with self._lock:
            s, c = self._acc.get(name, (0.0, 0))
            self._acc[name] = (s + seconds, c + count)

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()

    def report(self) -> str:
        with self._lock:
            items = sorted(self._acc.items(),
                           key=lambda kv: -kv[1][0])
        lines = [f"{name:<20} {1000 * s:10.1f} ms total "
                 f"{1000 * s / max(c, 1):8.2f} ms/call x{c}"
                 for name, (s, c) in items]
        return "\n".join(lines) if lines else "(no phases recorded)"

    def as_dict(self) -> dict:
        with self._lock:
            return {k: v for k, v in self._acc.items()}


phases = PhaseTimers()


@contextlib.contextmanager
def phase(name: str):
    t0 = time.monotonic()
    try:
        yield
    finally:
        phases.add(name, time.monotonic() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """JAX device profiler trace (XPlane protobufs under log_dir;
    inspect with xprof or TensorBoard's profile plugin)."""
    import jax
    with jax.profiler.trace(log_dir):
        yield
