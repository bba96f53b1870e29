"""Per-peer failure detection (the port of :mod:`dpwa_tpu.health.detector`).

:class:`Outcome` holds the fetch outcome classes as the reference's fetcher
reports them, the same strings, so a port node's ``last_fetch`` and
``last_round`` read as a reference node's.  :class:`FailureDetector` feeds
every outcome into a per-peer record: a suspicion score that each failure
raises by its kind's weight and each success decays multiplicatively, and
EWMAs of the latency and throughput of successes.  The quarantine decision
(:mod:`~dpwa_tpu_torch.health.scoreboard`) reads the suspicion alone, a
function of the outcome sequence, never of the clock, so replicas that
see the same outcomes reach the same state; the EWMAs and :meth:`phi` are
for observation only.  Plain Python, the reference's arithmetic line for
line: the snapshots of the two packages are equal after equal histories.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional


class Outcome:
    """Fetch outcome classes (plain strings, so they serialise as they are)."""

    SUCCESS = "success"
    TIMEOUT = "timeout"  # the cumulative deadline lapsed with nothing received
    REFUSED = "refused"  # the connect failed: nothing listening
    SHORT_READ = "short_read"  # the peer closed or reset mid-frame
    CORRUPT = "corrupt"  # bad magic, version or code, oversize, undecodable
    POISONED = "poisoned"  # a well-formed frame the recovery guard rejected
    UNTRUSTED = "untrusted"  # rejected by the trust screen
    BUSY = "busy"  # the peer shed the request with a BUSY frame
    SLOW = "slow"  # the deadline lapsed while bytes were still flowing
    STALE = "stale"  # an async round's frame too old to merge, or a publish clock merged already

    FAILURES = (
        TIMEOUT, REFUSED, SHORT_READ, CORRUPT, POISONED, UNTRUSTED,
        BUSY, SLOW, STALE,
    )
    ALL = (SUCCESS,) + FAILURES
    # Load signals, not death signals: they degrade a peer, never
    # quarantine it.
    SOFT = (BUSY, SLOW, STALE)


# Evidence added to the suspicion score per failure, by kind.  A refused
# connection or a truncated frame is direct evidence the process is gone
# (weight 1.0: two in a row cross the default threshold of 2.0); a
# corrupt frame is a protocol violation — something is seriously wrong
# on the other side — and weighs slightly more; a timeout is the
# weakest signal (the network, not the peer, may be at fault).  A
# poisoned payload (clean frame, sick contents) is as damning as a
# corrupt one: merging it would actively damage the local replica; an
# untrusted payload (finite but byzantine content) is the same class of
# harm, caught one layer later.  Busy/slow are LOAD evidence, not death
# evidence — weight 0.25 so a loaded-but-honest peer is deprioritized
# slowly (8 soft failures to cross the default 2.0 threshold) and, per
# the scoreboard's soft-degrade rule, lands in DEGRADED rather than
# QUARANTINED when it does.
DEFAULT_FAILURE_WEIGHTS: Mapping[str, float] = {
    Outcome.TIMEOUT: 1.0,
    Outcome.REFUSED: 1.0,
    Outcome.SHORT_READ: 1.0,
    Outcome.CORRUPT: 1.5,
    Outcome.POISONED: 1.5,
    Outcome.UNTRUSTED: 1.5,
    Outcome.BUSY: 0.25,
    Outcome.SLOW: 0.25,
    Outcome.STALE: 0.25,
}


@dataclasses.dataclass
class PeerRecord:
    """Mutable per-peer statistics (one per remote peer)."""

    suspicion: float = 0.0
    failure_streak: int = 0
    attempts: int = 0
    successes: int = 0
    failures: int = 0
    # EWMA of success latency (seconds) and its variance — the
    # phi-accrual sufficient statistics; None until the first success.
    ewma_latency_s: Optional[float] = None
    ewma_latency_var: float = 0.0
    # EWMA of achieved payload throughput (bytes/s) on successes.
    ewma_throughput_bps: Optional[float] = None
    outcome_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    last_outcome: Optional[str] = None


class FailureDetector:
    """Accumulates fetch outcomes into per-peer suspicion + EWMAs.

    ``suspicion`` semantics: 0 is full health; each failure adds its
    kind's weight; each success multiplies by ``success_decay`` (default
    0.25 — one good fetch forgives most of a bad streak, three forgive
    essentially all of it).  Crossing ``threshold`` (held by the
    scoreboard, not here) means "stop spending fetch budget on this
    peer".
    """

    def __init__(
        self,
        ewma_alpha: float = 0.2,
        success_decay: float = 0.25,
        failure_weights: Optional[Mapping[str, float]] = None,
    ):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        if not 0.0 <= success_decay < 1.0:
            raise ValueError(
                f"success_decay must be in [0, 1), got {success_decay}"
            )
        self.ewma_alpha = ewma_alpha
        self.success_decay = success_decay
        self.failure_weights = dict(
            failure_weights
            if failure_weights is not None
            else DEFAULT_FAILURE_WEIGHTS
        )
        self._peers: Dict[int, PeerRecord] = {}

    def record(self, peer: int) -> PeerRecord:
        rec = self._peers.get(peer)
        if rec is None:
            rec = self._peers[peer] = PeerRecord()
        return rec

    def observe(
        self,
        peer: int,
        outcome: str,
        latency_s: Optional[float] = None,
        nbytes: int = 0,
    ) -> float:
        """Feed one fetch outcome; returns the peer's updated suspicion."""
        rec = self.record(peer)
        rec.attempts += 1
        rec.last_outcome = outcome
        rec.outcome_counts[outcome] = rec.outcome_counts.get(outcome, 0) + 1
        if outcome == Outcome.SUCCESS:
            rec.successes += 1
            rec.failure_streak = 0
            rec.suspicion *= self.success_decay
            if rec.suspicion < 1e-6:
                rec.suspicion = 0.0
            if latency_s is not None and latency_s >= 0.0:
                a = self.ewma_alpha
                if rec.ewma_latency_s is None:
                    rec.ewma_latency_s = latency_s
                else:
                    delta = latency_s - rec.ewma_latency_s
                    rec.ewma_latency_s += a * delta
                    rec.ewma_latency_var = (1 - a) * (
                        rec.ewma_latency_var + a * delta * delta
                    )
                if nbytes > 0 and latency_s > 0.0:
                    bps = nbytes / latency_s
                    if rec.ewma_throughput_bps is None:
                        rec.ewma_throughput_bps = bps
                    else:
                        rec.ewma_throughput_bps += a * (
                            bps - rec.ewma_throughput_bps
                        )
        else:
            if outcome not in self.failure_weights:
                raise ValueError(f"unknown fetch outcome {outcome!r}")
            rec.failures += 1
            rec.failure_streak += 1
            rec.suspicion += self.failure_weights[outcome]
        return rec.suspicion

    def suspicion(self, peer: int) -> float:
        rec = self._peers.get(peer)
        return rec.suspicion if rec is not None else 0.0

    def evict(self, peer: int) -> None:
        """Drop ``peer``'s record entirely (membership eviction): its
        EWMAs and counters rematerialize from zero if it ever returns."""
        self._peers.pop(peer, None)

    def phi(self, peer: int, elapsed_since_success_s: float) -> float:
        """Phi-accrual suspicion from the latency distribution.

        ``-log10 P(a fetch takes this long | the latency EWMA)`` under a
        normal model — the classic phi-accrual statistic (Hayashibara et
        al.).  OBSERVABILITY ONLY: it reads wall-clock input, so it never
        gates quarantine (which must stay deterministic across lock-step
        replicas); dashboards use it to rank how overdue a peer is."""
        rec = self._peers.get(peer)
        if rec is None or rec.ewma_latency_s is None:
            return 0.0
        mean = rec.ewma_latency_s
        std = max(math.sqrt(rec.ewma_latency_var), mean * 0.1, 1e-6)
        z = (elapsed_since_success_s - mean) / std
        if z <= 0.0:
            return 0.0
        # P(X > x) for a normal tail, via the complementary error function.
        p = 0.5 * math.erfc(z / math.sqrt(2.0))
        return -math.log10(max(p, 1e-15))

    def snapshot(self, peer: int) -> dict:
        """JSON-ready statistics for one peer."""
        rec = self._peers.get(peer)
        if rec is None:
            rec = PeerRecord()
        return {
            "suspicion": round(rec.suspicion, 4),
            "failure_streak": rec.failure_streak,
            "attempts": rec.attempts,
            "successes": rec.successes,
            "failures": rec.failures,
            "ewma_latency_ms": (
                round(rec.ewma_latency_s * 1e3, 3)
                if rec.ewma_latency_s is not None
                else None
            ),
            "ewma_throughput_mbps": (
                round(rec.ewma_throughput_bps / 1e6, 3)
                if rec.ewma_throughput_bps is not None
                else None
            ),
            "outcomes": dict(rec.outcome_counts),
            "last_outcome": rec.last_outcome,
        }
