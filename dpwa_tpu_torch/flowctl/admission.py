"""Serving-side admission control of the Rx server (the port of
:mod:`dpwa_tpu.flowctl.admission`).

Four gates, each shedding load explicitly (the server answers a ``DPWB``
busy frame and closes) rather than queueing work it cannot finish: a
global cap on live connections (``max_connections``), a token bucket per
remote address (``token_rate``, ``token_burst``), a ceiling on payload
bytes being sent (``max_inflight_bytes``), and the eviction of a request
read slower than ``min_ingest_bytes_per_s`` (counted here, enforced by the
server).  Token refills are a rate, so admission reads a clock (injectable
for tests); it feeds no deterministic state machine: a shed is a ``busy``
outcome on the fetcher, soft evidence that never quarantines.  Every
public method takes the lock.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Optional, Tuple

from dpwa_tpu_torch.config import FlowctlConfig
from dpwa_tpu_torch.flowctl.vclock import monotonic_now


class AdmissionController:
    """The Rx server's shed-or-serve gatekeeper."""

    def __init__(self, config: Optional[FlowctlConfig] = None,
                 clock: Callable[[], float] = monotonic_now):
        self.config = config if config is not None else FlowctlConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._active = 0
        self._peak_active = 0
        self._inflight_bytes = 0
        self._buckets: Dict[str, Tuple[float, float]] = {}  # host -> (tokens, last refill)
        self._admitted = 0
        self._sheds: Dict[str, int] = {"connections": 0, "tokens": 0, "bytes": 0}
        self._evictions = 0

    def _refill(self, host: str, now: float) -> float:
        tokens, last = self._buckets.get(host, (float(self.config.token_burst), now))
        return min(float(self.config.token_burst), tokens + (now - last) * self.config.token_rate)

    def admit(self, host: str) -> Tuple[bool, int]:
        """Admit one connection from ``host``: ``(True, 0)``, counted active
        until its :meth:`release`, or ``(False, retry_ms)``, the busy
        frame's hint."""
        with self._lock:
            now = self._clock()
            if self._active >= self.config.max_connections:
                self._sheds["connections"] += 1
                return False, self.config.busy_retry_ms
            tokens = self._refill(host, now)
            if tokens < 1.0:
                self._sheds["tokens"] += 1
                self._buckets[host] = (tokens, now)
                retry_ms = int(math.ceil((1.0 - tokens) / self.config.token_rate * 1e3))
                return False, max(retry_ms, self.config.busy_retry_ms)
            self._buckets[host] = (tokens - 1.0, now)
            self._active += 1
            self._peak_active = max(self._peak_active, self._active)
            self._admitted += 1
            return True, 0

    def release(self, host: str) -> None:
        with self._lock:
            self._active = max(0, self._active - 1)

    def reserve_bytes(self, nbytes: int) -> bool:
        """Reserve ``nbytes`` for one blob send; False (a ``bytes`` shed)
        when that would cross the ceiling."""
        with self._lock:
            if self._inflight_bytes + nbytes > self.config.max_inflight_bytes:
                self._sheds["bytes"] += 1
                return False
            self._inflight_bytes += nbytes
            return True

    def release_bytes(self, nbytes: int) -> None:
        with self._lock:
            self._inflight_bytes = max(0, self._inflight_bytes - nbytes)

    def note_eviction(self) -> None:
        """A request read missed its deadline and its connection was cut."""
        with self._lock:
            self._evictions += 1

    @property
    def shed_total(self) -> int:
        with self._lock:
            return sum(self._sheds.values())

    def snapshot(self) -> dict:
        """JSON-ready admission counters."""
        with self._lock:
            return {
                "active": self._active,
                "peak_active": self._peak_active,
                "inflight_bytes": self._inflight_bytes,
                "admitted": self._admitted,
                "sheds": dict(self._sheds),
                "shed_total": sum(self._sheds.values()),
                "evictions": self._evictions,
            }


def register_metrics(registry, admission: AdmissionController) -> None:
    """The serving admission gates on a ``/metrics`` registry."""
    from dpwa_tpu_torch.obs.prometheus import Family

    def collect():
        snap = admission.snapshot()
        sheds = Family("dpwa_admission_sheds_total", "counter",
                       "Requests shed by the serving admission gates, by reason")
        for reason, n in sorted((snap.get("sheds") or {}).items()):
            sheds.sample(n, {"reason": reason})
        return [
            Family("dpwa_admission_active_connections", "gauge",
                   "Rx connections currently being served").sample(snap.get("active")),
            Family("dpwa_admission_inflight_bytes", "gauge",
                   "Payload bytes currently in flight to fetchers").sample(
                snap.get("inflight_bytes")),
            Family("dpwa_admission_admitted_total", "counter",
                   "Requests admitted past the serving gates").sample(snap.get("admitted")),
            Family("dpwa_admission_evictions_total", "counter",
                   "Slow-loris connections evicted mid-read").sample(snap.get("evictions")),
            sheds,
        ]

    registry.register(collect)
