"""Per-peer adaptive fetch deadlines from observed success latencies (the
port of :mod:`dpwa_tpu.flowctl.estimator`).

Per peer, a bounded window of SUCCESS latencies (failures measure our own
budget, not the peer) gives:

- the deadline: ``quantile(window) * margin`` clamped to ``[min_ms,
  max_ms]``; cold (fewer than ``warmup`` samples), the static
  ``timeout_ms``;
- the hedge launch point: the un-margined quantile, clamped alike, or None
  while cold (a cold estimator never hedges).

Busy, slow and hedge outcomes are counted for the snapshot but never enter
the window.  The snapshot lists the peers with resident state only
(:meth:`DeadlineEstimator.tracked_peers`), the residency the partial
view's ``state_cap`` bounds through the membership's evict listener.  Latencies arrive as arguments, so nothing here reads the wall
clock.  Every public method takes the lock: fetch legs run on their own
threads.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Callable, Deque, Dict, Optional

from dpwa_tpu_torch.config import FlowctlConfig
from dpwa_tpu_torch.flowctl.vclock import monotonic_now
from dpwa_tpu_torch.health.detector import Outcome


class DeadlineEstimator:
    """Latency-quantile deadlines and hedge, busy and slow counts, per peer."""

    def __init__(
        self,
        config: Optional[FlowctlConfig] = None,
        timeout_ms: float = 500.0,
        now: Optional[Callable[[], float]] = None,
    ):
        self.config = config if config is not None else FlowctlConfig()
        self.timeout_ms = float(timeout_ms)
        # The plane's time seam; the estimator itself never reads it.
        self.now: Callable[[], float] = now if now is not None else monotonic_now
        self._lock = threading.Lock()
        self._window: Dict[int, Deque[float]] = {}
        self._counts: Dict[int, Dict[str, int]] = {}
        self._hedges = 0
        self._hedge_wins = 0

    def _peer_counts(self, peer: int) -> Dict[str, int]:
        c = self._counts.get(peer)
        if c is None:
            c = self._counts[peer] = {"busy": 0, "slow": 0, "hedges": 0, "hedge_wins": 0}
        return c

    def observe(self, peer: int, outcome: str, latency_s: Optional[float] = None,
                nbytes: int = 0) -> None:
        """Feed one classified fetch outcome."""
        with self._lock:
            counts = self._peer_counts(peer)
            if outcome == Outcome.SUCCESS:
                if latency_s is not None and latency_s >= 0.0:
                    win = self._window.get(peer)
                    if win is None:
                        win = self._window[peer] = deque(maxlen=self.config.window)
                    win.append(float(latency_s) * 1e3)
            elif outcome == Outcome.BUSY:
                counts["busy"] += 1
            elif outcome == Outcome.SLOW:
                counts["slow"] += 1

    def note_hedge(self, peer: int) -> None:
        """A hedged fetch was launched because ``peer`` lapsed its budget."""
        with self._lock:
            self._hedges += 1
            self._peer_counts(peer)["hedges"] += 1

    def note_hedge_win(self, peer: int) -> None:
        """The hedge against ``peer`` won the race."""
        with self._lock:
            self._hedge_wins += 1
            self._peer_counts(peer)["hedge_wins"] += 1

    def evict_peer(self, peer: int) -> None:
        """Drop ``peer``'s window and counts (a membership eviction): a
        rejoiner warms up from scratch."""
        with self._lock:
            self._window.pop(peer, None)
            self._counts.pop(peer, None)

    def tracked_peers(self) -> list:
        """Every peer with a window or counts."""
        with self._lock:
            return sorted(set(self._window) | set(self._counts))

    def _quantile_ms(self, peer: int, q: float) -> Optional[float]:
        win = self._window.get(peer)
        if win is None or len(win) < self.config.warmup:
            return None
        samples = sorted(win)
        return samples[min(len(samples) - 1, max(0, math.ceil(q * len(samples)) - 1))]

    def _deadline(self, q: Optional[float]) -> float:
        if q is None:
            return self.timeout_ms
        return min(self.config.max_ms, max(self.config.min_ms, q * self.config.margin))

    def warm(self, peer: int) -> bool:
        """Whether ``peer`` has ``warmup`` success samples."""
        with self._lock:
            win = self._window.get(peer)
            return win is not None and len(win) >= self.config.warmup

    def deadline_ms(self, peer: int) -> float:
        """The cumulative budget of ``peer``'s next fetch."""
        with self._lock:
            return self._deadline(self._quantile_ms(peer, self.config.quantile))

    def hedge_launch_ms(self, peer: int) -> Optional[float]:
        """When (ms into the fetch) the hedge launches, or None while cold."""
        with self._lock:
            q = self._quantile_ms(peer, self.config.quantile)
            if q is None:
                return None
            return min(self.config.max_ms, max(self.config.min_ms, q))

    def snapshot(self) -> dict:
        """JSON-ready: per-peer samples, median, quantile and deadline, and
        the hedge, busy and slow counts."""
        with self._lock:
            peers = {}
            for peer in sorted(set(self._window) | set(self._counts)):
                win = self._window.get(peer)
                counts = self._peer_counts(peer)
                p50 = self._quantile_ms(peer, 0.5)
                q = self._quantile_ms(peer, self.config.quantile)
                peers[peer] = {
                    "samples": len(win) if win is not None else 0,
                    "p50_ms": round(p50, 3) if p50 is not None else None,
                    "q_ms": round(q, 3) if q is not None else None,
                    "deadline_ms": round(self._deadline(q), 3),
                    "hedges": counts["hedges"],
                    "hedge_wins": counts["hedge_wins"],
                    "busy": counts["busy"],
                    "slow": counts["slow"],
                }
            return {
                "quantile": self.config.quantile,
                "hedges": self._hedges,
                "hedge_wins": self._hedge_wins,
                "peers": peers,
            }


def register_metrics(registry, estimator: DeadlineEstimator) -> None:
    """Adaptive deadlines and hedging on a ``/metrics`` registry."""
    from dpwa_tpu_torch.obs.prometheus import Family

    def collect():
        snap = estimator.snapshot()
        deadline = Family("dpwa_flowctl_deadline_ms", "gauge",
                          "Adaptive cumulative fetch deadline per peer")
        p50 = Family("dpwa_flowctl_latency_p50_ms", "gauge",
                     "Median observed success latency per peer")
        for p, info in sorted((snap.get("peers") or {}).items()):
            labels = {"peer": p}
            deadline.sample(info.get("deadline_ms"), labels)
            p50.sample(info.get("p50_ms"), labels)
        return [
            deadline,
            p50,
            Family("dpwa_flowctl_hedges_total", "counter",
                   "Hedged retries launched").sample(snap.get("hedges")),
            Family("dpwa_flowctl_hedge_wins_total", "counter",
                   "Hedged retries that beat the primary").sample(snap.get("hedge_wins")),
        ]

    registry.register(collect)
