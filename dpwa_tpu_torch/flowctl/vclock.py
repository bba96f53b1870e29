"""An injectable time source for the flow control plane (the port of
:mod:`dpwa_tpu.flowctl.vclock`): :data:`monotonic_now` in production, a
:class:`VirtualClock` in tests, so a test drives every wall-time quantity
of the plane (the admission's token refills) by its ``advance`` calls."""

from __future__ import annotations

import threading
import time

# The production clock.
monotonic_now = time.monotonic


class VirtualClock:
    """A thread-safe clock that advances only when told to; an instance is
    a zero-argument callable, like ``time.monotonic``."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def __call__(self) -> float:
        return self.now()

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds; returns the new time."""
        if dt < 0:
            raise ValueError(f"virtual clock cannot rewind (dt={dt})")
        with self._lock:
            self._t += float(dt)
            return self._t

    def sleep(self, dt: float) -> None:
        """A virtual sleep: advances the clock, costs no wall time."""
        self.advance(dt)
