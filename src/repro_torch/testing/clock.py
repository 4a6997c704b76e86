"""An injectable monotonic clock for deadline tests.

Every timing-sensitive component (`ServingEngine`, `MicroBatcher`,
`DynamicBatcher`, `Prefetcher`, `ServingGateway`) takes a ``clock=``
parameter: a zero-arg callable returning seconds, defaulting to
``time.monotonic``. Tests pass a :class:`FakeClock` and call
``advance()`` instead of sleeping, which kills the slow-host flake
class outright — a deadline test runs in microseconds and cannot be
perturbed by scheduler jitter.
"""
from __future__ import annotations

import threading


class FakeClock:
    """A deterministic stand-in for ``time.monotonic``.

    The instance itself is the clock callable (``clock()`` returns the
    current fake time in seconds); time only moves when the test calls
    :meth:`advance`. Thread-safe: serving components read the clock from
    executor pool threads while the test advances it.
    """

    def __init__(self, start: float = 0.0):
        self._lock = threading.Lock()
        self._now = float(start)

    def __call__(self) -> float:
        """Current fake time in seconds (monotonic, never decreases)."""
        with self._lock:
            return self._now

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds and return the new time."""
        if dt < 0:
            raise ValueError(f"FakeClock cannot go backwards (dt={dt})")
        with self._lock:
            self._now += float(dt)
            return self._now

    def sleep(self, dt: float) -> None:
        """Drop-in for ``time.sleep`` in monkeypatched code paths."""
        self.advance(dt)

    def __repr__(self) -> str:
        return f"FakeClock(t={self():.6f})"
