"""Peer-health scoreboard: quarantine, exponential backoff, re-admission
(the port of :mod:`dpwa_tpu.health.scoreboard`).

The acting half of the health plane (sensing is
:mod:`~dpwa_tpu_torch.health.detector`).  Per remote peer, a small state
machine: ``healthy`` → (suspicion ≥ threshold) → ``quarantined`` →
(backoff elapses) probe due → (header probe ok) ``healthy``, or the probe
fails and the peer is quarantined again with its backoff doubled.  While a
peer is quarantined the transport spends no fetch on it: the schedule
remaps the round to a healthy fallback
(:meth:`~dpwa_tpu_torch.parallel.schedules.Schedule.remap_partner`).  The
backoff is ``base · 2^(k-1)`` rounds, clamped, plus the threefry jitter of
:func:`~dpwa_tpu_torch.parallel.schedules.backoff_jitter_draw`.  Every
clock here counts rounds, never wall time: equal outcome sequences give
equal quarantine windows, on every replica and in either package.

The membership manager attaches itself (:meth:`Scoreboard.attach_membership`):
the snapshot then carries its view, an evicted peer's successful probe
tells it the peer is back, and it evicts peers held dead
(:meth:`Scoreboard.evict_peer`).  :func:`register_metrics` exposes it on
``/metrics``.  Every public method takes the internal lock.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Union

from dpwa_tpu_torch.config import HealthConfig
from dpwa_tpu_torch.health.detector import (
    DEFAULT_FAILURE_WEIGHTS,
    FailureDetector,
    Outcome,
)
from dpwa_tpu_torch.parallel.schedules import backoff_jitter_draw


class PeerState:
    """Peer health states (plain strings: they ride into JSONL metrics)."""

    HEALTHY = "healthy"
    SUSPECT = "suspect"  # nonzero suspicion, below the quarantine threshold
    QUARANTINED = "quarantined"
    # Soft-degraded: suspicion crossed the threshold on LOAD evidence
    # alone (busy/slow outcomes, the flowctl plane).  The peer is alive
    # and honest, just overloaded — it is deprioritized (excluded from
    # fallback remaps, fractionally shed as a scheduled partner) but
    # KEEPS receiving direct fetches under its short adaptive budget, so
    # success evidence can decay it back out.  Soft evidence never
    # promotes to QUARANTINED; a hard failure while degraded still does.
    DEGRADED = "degraded"


class Scoreboard:
    """Tracks health state for every remote peer of one local node."""

    def __init__(
        self,
        n_peers: int,
        me: int,
        config: Optional[HealthConfig] = None,
        seed: int = 0,
    ):
        self.config = config if config is not None else HealthConfig()
        self.n_peers = n_peers
        self.me = me
        self.seed = seed
        self.detector = FailureDetector(
            ewma_alpha=self.config.ewma_alpha,
            success_decay=self.config.success_decay,
        )
        self._lock = threading.Lock()
        self._state: Dict[int, str] = {}
        # Round the current quarantine ends (probe becomes due).
        self._release_round: Dict[int, int] = {}
        # Consecutive quarantines without an intervening successful probe.
        self._quarantine_streak: Dict[int, int] = {}
        self._quarantines: Dict[int, int] = {}  # lifetime count
        self._quarantined_rounds: Dict[int, int] = {}  # lifetime total
        self._quarantined_at: Dict[int, int] = {}
        self._degrades: Dict[int, int] = {}  # lifetime soft-degrade count
        self._degraded_rounds: Dict[int, int] = {}  # lifetime total
        self._degraded_at: Dict[int, int] = {}
        self._probe_attempts: Dict[int, int] = {}
        self._probe_successes: Dict[int, int] = {}
        # Round of last direct contact (fetch outcome or probe) per
        # peer — the recency signal the partial-view LRU cap orders
        # victims by.  Pruned on eviction.
        self._last_contact: Dict[int, int] = {}
        # Membership-evicted peers (peer -> round evicted).  Every other
        # per-peer dict is pruned at eviction, and `_state.get(peer,
        # HEALTHY)` defaults healthy, so this set is what keeps a
        # departed ghost out of healthy_mask / partner remaps until a
        # probe or a fresher-incarnation refutation brings it back.
        self._evicted: Dict[int, int] = {}
        self._round = 0  # highest round observed (fallback clock)
        # The membership manager, once attached (its view rides the snapshot).
        self._membership: Optional[Any] = None

    # ------------------------------------------------------------------
    # Outcome ingestion
    # ------------------------------------------------------------------

    def record(
        self,
        peer: int,
        outcome: str,
        latency_s: Optional[float] = None,
        nbytes: int = 0,
        round: Optional[int] = None,
    ) -> str:
        """Feed one fetch outcome; returns the peer's resulting state."""
        with self._lock:
            r = self._clock(round)
            if peer in self._evicted:
                # Stray outcomes against an evicted ghost (a late fetch
                # completion, a relayed probe) must not regrow its state
                # — re-admission goes through record_probe/readmit only.
                return PeerState.QUARANTINED
            self._last_contact[peer] = r
            suspicion = self.detector.observe(peer, outcome, latency_s, nbytes)
            if self._state.get(peer) != PeerState.QUARANTINED:
                self._apply_suspicion(peer, outcome, suspicion, r)
            return self._state.get(peer, PeerState.HEALTHY)

    def _apply_suspicion(
        self, peer: int, outcome: str, suspicion: float, r: int
    ) -> None:
        """State transition for a non-quarantined peer (lock held).

        Soft outcomes (busy/slow — load evidence) crossing the threshold
        DEGRADE the peer instead of quarantining it; so does a success
        still draining a large soft-suspicion backlog (a degraded peer is
        the only non-quarantined state whose suspicion can sit above the
        threshold, so a single success may not clear it).  A hard failure
        crossing the threshold quarantines as before — degraded or not."""
        if suspicion >= self.config.suspicion_threshold:
            if outcome == Outcome.SUCCESS or outcome in Outcome.SOFT:
                self._enter_degraded(peer, r)
            else:
                self._exit_degraded(peer, r)
                self._enter_quarantine(peer, r)
        elif suspicion > 0.0:
            self._exit_degraded(peer, r)
            self._state[peer] = PeerState.SUSPECT
        else:
            self._exit_degraded(peer, r)
            self._state[peer] = PeerState.HEALTHY

    def record_probe(
        self,
        peer: int,
        ok: Union[bool, str],
        round: Optional[int] = None,
    ):
        """Result of a header probe against ``peer``.

        ``ok`` is either a bool (legacy re-admission form) or a
        classified :class:`~dpwa_tpu_torch.health.detector.Outcome` string, so
        relay/readmission probes feed suspicion symmetrically with
        fetches.  A QUARANTINED peer keeps the original re-admission
        semantics (success readmits, failure doubles the backoff); a
        non-quarantined peer's probe outcome flows through the detector
        exactly like a fetch outcome — a relayed success decays a false
        suspicion, a relayed failure is corroborating evidence."""
        if isinstance(ok, str):
            outcome = ok
            success = outcome == Outcome.SUCCESS
        else:
            success = bool(ok)
            outcome = Outcome.SUCCESS if success else Outcome.REFUSED
        with self._lock:
            r = self._clock(round)
            if peer in self._evicted:
                # Evicted ghosts accumulate NO state on failed probes —
                # that unboundedness is what eviction exists to stop.  A
                # successful probe is direct evidence the peer is back:
                # rebuild it from scratch.
                if not success:
                    return
                del self._evicted[peer]
                self._state[peer] = PeerState.HEALTHY
                self._quarantine_streak[peer] = 0
                self._probe_attempts[peer] = 1
                self._probe_successes[peer] = 1
                self._last_contact[peer] = r
                rec = self.detector.record(peer)
                rec.suspicion = 0.0
                rec.failure_streak = 0
                # The membership plane clears its eviction (the
                # scoreboard-then-manager lock order).
                if self._membership is not None:
                    self._membership.on_peer_returned(peer, r)
                return
            self._probe_attempts[peer] = self._probe_attempts.get(peer, 0) + 1
            self._last_contact[peer] = r
            if self._state.get(peer) != PeerState.QUARANTINED:
                # Symmetric path: probes are evidence, same as fetches.
                if success:
                    self._probe_successes[peer] = (
                        self._probe_successes.get(peer, 0) + 1
                    )
                suspicion = self.detector.observe(peer, outcome)
                self._apply_suspicion(peer, outcome, suspicion, r)
                return
            self._settle_quarantined_rounds(peer, r)
            if success:
                self._probe_successes[peer] = (
                    self._probe_successes.get(peer, 0) + 1
                )
                self._state[peer] = PeerState.HEALTHY
                self._quarantine_streak[peer] = 0
                rec = self.detector.record(peer)
                rec.suspicion = 0.0
                rec.failure_streak = 0
            else:
                # Still dead: back off again, twice as long.
                self._enter_quarantine(peer, r)

    def would_quarantine(self, peer: int, outcome: str) -> bool:
        """True when recording ``outcome`` against ``peer`` NOW would
        cross the quarantine threshold — the transport's trigger for
        indirect probing: ask relays *before* the promoting record."""
        if outcome in Outcome.SOFT:
            # Load evidence degrades, never quarantines.
            return False
        weight = DEFAULT_FAILURE_WEIGHTS.get(outcome)
        if weight is None:
            return False
        with self._lock:
            if self._state.get(peer) == PeerState.QUARANTINED:
                return False
            current = self.detector.suspicion(peer)
            return current + weight >= self.config.suspicion_threshold

    def readmit(self, peer: int, round: Optional[int] = None) -> bool:
        """Force ``peer`` back to healthy on refutation evidence (it
        disseminated ``alive`` at a higher incarnation than our
        suspicion/quarantine of it).  Returns True when state changed."""
        with self._lock:
            r = self._clock(round)
            if peer in self._evicted:
                # A refuted eviction: the peer disseminated a fresher
                # alive claim, so it rematerializes with a clean record
                # (the caller — the membership manager — clears its own
                # eviction bookkeeping).
                del self._evicted[peer]
                self._state[peer] = PeerState.HEALTHY
                self._quarantine_streak[peer] = 0
                rec = self.detector.record(peer)
                rec.suspicion = 0.0
                rec.failure_streak = 0
                return True
            state = self._state.get(peer, PeerState.HEALTHY)
            if state == PeerState.HEALTHY:
                return False
            self._settle_quarantined_rounds(peer, r)
            self._exit_degraded(peer, r)
            self._state[peer] = PeerState.HEALTHY
            self._quarantine_streak[peer] = 0
            rec = self.detector.record(peer)
            rec.suspicion = 0.0
            rec.failure_streak = 0
            return True

    def adopt_quarantine(self, peer: int, round: Optional[int] = None) -> bool:
        """Adopt a REMOTE quarantine claim disseminated by the digest:
        quarantine ``peer`` without local failure evidence, with the
        standard streak backoff.  No-op (False) when already quarantined."""
        with self._lock:
            r = self._clock(round)
            if self._state.get(peer) == PeerState.QUARANTINED:
                return False
            self._exit_degraded(peer, r)
            self._enter_quarantine(peer, r)
            return True

    def quarantine_streak(self, peer: int) -> int:
        """Consecutive failed re-admissions (feeds the ``dead`` label)."""
        with self._lock:
            return self._quarantine_streak.get(peer, 0)

    def evict_peer(self, peer: int, round: Optional[int] = None) -> bool:
        """Prune EVERY per-peer record for a membership-evicted peer.

        Called by the membership manager once a peer has been
        disseminated dead for ``membership.dead_gossip_rounds`` — the
        churn-hardening bound on O(N)-forever state.
        The peer keeps reading as quarantined (see :meth:`state`,
        :meth:`healthy_mask`) off the one-entry ``_evicted`` map; a
        periodic probe (:meth:`probe_due`) or a fresher-incarnation
        refutation readmits it from scratch.  Returns True when newly
        evicted."""
        with self._lock:
            r = self._clock(round)
            if peer in self._evicted or peer == self.me:
                return False
            for d in (
                self._state,
                self._release_round,
                self._quarantine_streak,
                self._quarantines,
                self._quarantined_rounds,
                self._quarantined_at,
                self._degrades,
                self._degraded_rounds,
                self._degraded_at,
                self._probe_attempts,
                self._probe_successes,
                self._last_contact,
            ):
                d.pop(peer, None)
            self.detector.evict(peer)
            self._evicted[peer] = r
            return True

    def tracked_peers(self) -> List[int]:
        """Every peer with resident per-peer state in ANY scoreboard or
        detector map (tombstones excluded) — the residency set the
        partial-view ``state_cap`` bounds."""
        with self._lock:
            keys = (
                set(self._state)
                | set(self._quarantine_streak)
                | set(self._quarantines)
                | set(self._degrades)
                | set(self._probe_attempts)
                | set(self._last_contact)
                | set(self.detector._peers)
            )
            keys -= set(self._evicted)
            keys.discard(self.me)
            return sorted(keys)

    def last_contact_map(self) -> Dict[int, int]:
        """Copy of the per-peer last-direct-contact rounds (LRU input)."""
        with self._lock:
            return dict(self._last_contact)

    def is_evicted(self, peer: int) -> bool:
        with self._lock:
            return peer in self._evicted

    def evicted_peers(self) -> List[int]:
        """Currently evicted peers, ascending."""
        with self._lock:
            return sorted(self._evicted)

    def suspicion(self, peer: int) -> float:
        with self._lock:
            return self.detector.suspicion(peer)

    def attach_membership(self, provider: Any) -> None:
        """Attach the membership manager: health snapshots carry its view,
        and an evicted peer's successful probe reaches its
        ``on_peer_returned``."""
        with self._lock:
            self._membership = provider

    # ------------------------------------------------------------------
    # Queries (the transport's decision points)
    # ------------------------------------------------------------------

    def is_quarantined(self, peer: int, round: Optional[int] = None) -> bool:
        """True while the peer must receive zero fetch attempts."""
        with self._lock:
            self._clock(round)
            return (
                self._state.get(peer) == PeerState.QUARANTINED
                or peer in self._evicted
            )

    def is_degraded(self, peer: int, round: Optional[int] = None) -> bool:
        """True while the peer is soft-degraded (load, not death): the
        flowctl plane fractionally sheds scheduled rounds away from it
        but keeps fetching it on the rest."""
        with self._lock:
            self._clock(round)
            return self._state.get(peer) == PeerState.DEGRADED

    def probe_due(self, peer: int, round: Optional[int] = None) -> bool:
        """True when the backoff has elapsed and a cheap header-only
        probe should decide re-admission."""
        with self._lock:
            r = self._clock(round)
            evicted_at = self._evicted.get(peer)
            if evicted_at is not None:
                # Evicted ghosts get one cheap periodic probe so a
                # silently returned peer is rediscoverable even after
                # every node stopped disseminating its dead claim
                # (nobody gossips about a peer nobody tracks).
                interval = max(1, self.config.quarantine_max_rounds)
                return r > evicted_at and (r - evicted_at) % interval == 0
            return (
                self._state.get(peer) == PeerState.QUARANTINED
                and r >= self._release_round.get(peer, 0)
            )

    def probe_candidates(self, round: Optional[int] = None) -> List[int]:
        """Every peer whose probe is due at ``round``, ascending.

        Equivalent to ``[p for p in range(n) if probe_due(p, round)]``
        but O(quarantined + tombstones) instead of O(N) — it walks only
        the resident quarantine map and the eviction tombstones, which
        is what lets a 4096-peer orchestrator round stay O(tracked)."""
        with self._lock:
            r = self._clock(round)
            due = set()
            interval = max(1, self.config.quarantine_max_rounds)
            for p, evicted_at in self._evicted.items():
                if r > evicted_at and (r - evicted_at) % interval == 0:
                    due.add(p)
            for p, state in self._state.items():
                if (
                    state == PeerState.QUARANTINED
                    and r >= self._release_round.get(p, 0)
                ):
                    due.add(p)
            return sorted(due)

    def healthy_map(
        self, peers: List[int], round: Optional[int] = None
    ) -> Dict[int, bool]:
        """Fallback-target eligibility for just ``peers`` — the partial
        view's O(active) stand-in for :meth:`healthy_mask` (indexable by
        peer id, which is all ``Schedule.remap_partner`` needs)."""
        with self._lock:
            self._clock(round)
            return {
                p: self._state.get(p)
                not in (PeerState.QUARANTINED, PeerState.DEGRADED)
                and p not in self._evicted
                for p in peers
            }

    def healthy_mask(self, round: Optional[int] = None) -> List[bool]:
        """Per-peer eligibility as a fallback fetch target.

        Quarantined peers are excluded until a probe re-admits them;
        DEGRADED peers are excluded too — rerouting a failed round's
        traffic onto an already-overloaded peer would deepen the overload
        (they still get their own scheduled rounds, minus the shed
        fraction).  The local node itself is trivially 'healthy' but the
        remap never selects it anyway."""
        with self._lock:
            self._clock(round)
            return [
                self._state.get(p)
                not in (PeerState.QUARANTINED, PeerState.DEGRADED)
                and p not in self._evicted
                for p in range(self.n_peers)
            ]

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------

    def _clock(self, round: Optional[int]) -> int:
        """Advance/read the fallback round clock (callers hold _lock)."""
        if round is not None and round > self._round:
            self._round = int(round)
        return self._round

    def _enter_quarantine(self, peer: int, r: int) -> None:
        streak = self._quarantine_streak.get(peer, 0) + 1
        self._quarantine_streak[peer] = streak
        self._quarantines[peer] = self._quarantines.get(peer, 0) + 1
        backoff = min(
            self.config.quarantine_base_rounds * (1 << (streak - 1)),
            self.config.quarantine_max_rounds,
        )
        backoff += backoff_jitter_draw(
            self.seed, peer, streak, self.config.jitter_rounds
        )
        self._state[peer] = PeerState.QUARANTINED
        self._quarantined_at[peer] = r
        self._release_round[peer] = r + backoff
        self.detector.record(peer)  # materialize stats for the snapshot

    def _enter_degraded(self, peer: int, r: int) -> None:
        """Soft-degrade ``peer`` (lock held); idempotent while degraded."""
        if self._state.get(peer) != PeerState.DEGRADED:
            self._degrades[peer] = self._degrades.get(peer, 0) + 1
            self._degraded_at[peer] = r
            self._state[peer] = PeerState.DEGRADED

    def _exit_degraded(self, peer: int, r: int) -> None:
        """Fold a finished degraded window into the lifetime total
        (lock held; no-op when the peer is not degraded)."""
        if self._state.get(peer) == PeerState.DEGRADED:
            start = self._degraded_at.get(peer, r)
            self._degraded_rounds[peer] = self._degraded_rounds.get(
                peer, 0
            ) + max(0, r - start)
            self._degraded_at[peer] = r

    def _settle_quarantined_rounds(self, peer: int, r: int) -> None:
        """Fold the just-finished quarantine window into the lifetime
        total (called with the lock held, when a probe resolves it)."""
        if self._state.get(peer) == PeerState.QUARANTINED:
            start = self._quarantined_at.get(peer, r)
            self._quarantined_rounds[peer] = self._quarantined_rounds.get(
                peer, 0
            ) + max(0, r - start)
            self._quarantined_at[peer] = r

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def state(self, peer: int) -> str:
        with self._lock:
            if peer in self._evicted:
                return PeerState.QUARANTINED
            return self._state.get(peer, PeerState.HEALTHY)

    def snapshot(self, round: Optional[int] = None) -> dict:
        """JSON-ready health snapshot for metrics / the /healthz endpoint.

        Per remote peer: state, suspicion, quarantine accounting, and the
        detector's EWMA statistics.  With a membership manager attached,
        each peer's ``incarnation`` and a top-level ``membership`` dict (own
        incarnation, component, partition state)."""
        with self._lock:
            r = self._clock(round)
            membership = self._membership
            view = membership.view_snapshot() if membership is not None else None
            peers = {}
            for p in range(self.n_peers):
                if p == self.me or p in self._evicted:
                    continue
                state = self._state.get(p, PeerState.HEALTHY)
                quarantined_rounds = self._quarantined_rounds.get(p, 0)
                if state == PeerState.QUARANTINED:
                    quarantined_rounds += max(
                        0, r - self._quarantined_at.get(p, r)
                    )
                degraded_rounds = self._degraded_rounds.get(p, 0)
                if state == PeerState.DEGRADED:
                    degraded_rounds += max(
                        0, r - self._degraded_at.get(p, r)
                    )
                info = self.detector.snapshot(p)
                info.update(
                    state=state,
                    quarantined_rounds=quarantined_rounds,
                    quarantines=self._quarantines.get(p, 0),
                    degraded_rounds=degraded_rounds,
                    degrades=self._degrades.get(p, 0),
                    release_round=(
                        self._release_round.get(p)
                        if state == PeerState.QUARANTINED
                        else None
                    ),
                    probe_attempts=self._probe_attempts.get(p, 0),
                    probe_successes=self._probe_successes.get(p, 0),
                )
                if view is not None:
                    info["incarnation"] = view["incarnations"].get(p, 0)
                peers[p] = info
            snap = {"me": self.me, "round": r, "peers": peers}
            if self._evicted:
                snap["evicted"] = sorted(self._evicted)
            if view is not None:
                snap["membership"] = {k: v for k, v in view.items() if k != "incarnations"}
            return snap


def run_probe(
    probe_fn: Callable[[], bool], scoreboard: Scoreboard, peer: int,
    round: Optional[int] = None,
) -> bool:
    """Execute a re-admission probe and feed the result back in one step.

    ``probe_fn`` is the transport's cheap header-only probe (for TCP,
    :func:`dpwa_tpu_torch.parallel.tcp.probe_header` bound to the peer's
    address); any exception counts as a failed probe."""
    try:
        ok = bool(probe_fn())
    except Exception:
        ok = False
    scoreboard.record_probe(peer, ok, round)
    return ok


# The dpwa_peer_state gauge's codes.
_STATE_CODES = {
    PeerState.HEALTHY: 0,
    PeerState.SUSPECT: 1,
    PeerState.DEGRADED: 2,
    PeerState.QUARANTINED: 3,
}


def register_metrics(registry, scoreboard: Scoreboard) -> None:
    """The health plane on a :class:`~dpwa_tpu_torch.obs.prometheus.
    MetricsRegistry`: one :meth:`Scoreboard.snapshot` read a scrape."""
    from dpwa_tpu_torch.obs.prometheus import Family

    def collect():
        snap = scoreboard.snapshot()
        state = Family("dpwa_peer_state", "gauge",
                       "Scoreboard state per peer (0 healthy, 1 suspect, "
                       "2 degraded, 3 quarantined)")
        suspicion = Family("dpwa_peer_suspicion", "gauge",
                           "Failure-detector suspicion score per peer")
        quarantines = Family("dpwa_peer_quarantines_total", "counter",
                             "Lifetime quarantine entries per peer")
        attempts = Family("dpwa_peer_attempts_total", "counter",
                          "Exchange attempts recorded per peer")
        failures = Family("dpwa_peer_failures_total", "counter",
                          "Failed exchange attempts recorded per peer")
        for p, info in sorted(snap.get("peers", {}).items()):
            labels = {"peer": p}
            state.sample(_STATE_CODES.get(info.get("state")), labels)
            suspicion.sample(info.get("suspicion"), labels)
            quarantines.sample(info.get("quarantines"), labels)
            attempts.sample(info.get("attempts"), labels)
            failures.sample(info.get("failures"), labels)
        rnd = Family("dpwa_health_round", "counter", "Scoreboard round clock").sample(
            snap.get("round"))
        return [state, suspicion, quarantines, attempts, failures, rnd]

    registry.register(collect)
