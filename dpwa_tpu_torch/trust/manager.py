"""Per-peer trust policy: classify payloads, damp merges, feed quarantine
(the port of :mod:`dpwa_tpu.trust.manager`, for the dense wire).

The acting half of the content-trust plane (sensing is
:mod:`dpwa_tpu_torch.trust.screen`).  Per fetched payload the manager:

1. **Classifies** ``trusted / suspect / rejected``: robust z-scores of the
   payload's statistics against the median/MAD window of previously
   ACCEPTED exchanges (``mad_multiplier`` → suspect, ``reject_multiplier``
   → rejected), hard bounds no baseline excuses (cosine below
   ``cosine_floor``, a sign-flip; norm ratio above ``norm_ratio_max``) and
   a stale-replay check (a publish clock running backward).  Screening
   arms once ``min_window`` accepted exchanges exist.  A peer back from a
   long silence gets a re-acquaintance amnesty: for ``amnesty_rounds`` its
   hard rejections downgrade to damped suspects.
2. **Damps**: a per-peer trust EWMA in (0, 1]; the merge α is scaled by
   ``trust ** damping``, snapped to exactly 1.0 above 0.995, so an honest
   ring merges bit for bit as with trust off.
3. **Feeds the scoreboard**: a rejection is the ``untrusted`` outcome
   (recorded by the transport like ``poisoned``), and while trust sits
   below ``quarantine_trust`` every screening feeds
   ``Scoreboard.record_probe(peer, untrusted)``.

Everything here is a function of the observed payload sequence: no wall
clock, no RNG, so equal streams give equal verdicts, trust trajectories,
α scales and events, in either package.  A top-k frame is screened on its
support, a sharded frame slice against slice, each against baseline windows
of its own: per codec (``"topk"``, or a shard's inner ``"f32"``, ``"bf16"``,
``"int8"``, ``"topk"``) and per ``f"{codec}:s{shard}"``; ``"dense"`` is the
original set.  :func:`register_metrics` exposes the plane on ``/metrics``.
One lock guards all mutable state.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from dpwa_tpu_torch.config import TrustConfig
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.trust.screen import (
    BASE_STATS,
    RobustBaseline,
    leaf_starts_from_sizes,
    payload_stats,
    payload_stats_sparse,
)

# Verdict strings (stable: they ride into metrics JSONL and /healthz).
TRUSTED = "trusted"
SUSPECT = "suspect"
REJECTED = "rejected"


class TrustManager:
    """Content-trust state for one local node's view of its peers."""

    def __init__(
        self,
        n_peers: int,
        me: int,
        config: Optional[TrustConfig] = None,
        scoreboard: Optional[Any] = None,
    ):
        self.config = config if config is not None else TrustConfig()
        self.n_peers = n_peers
        self.me = me
        self.scoreboard = scoreboard
        self._lock = threading.Lock()
        # Global (not per-peer) baselines over accepted exchanges: the
        # honest ring IS the population a payload must resemble, and a
        # per-peer window would let a lone attacker define its own
        # normal.  Only fully-trusted payloads feed it, so an attacker
        # cannot walk the baseline toward its attack one suspect at a
        # time.
        self._baselines: Dict[str, RobustBaseline] = {
            s: RobustBaseline(self.config.window) for s in BASE_STATS
        }
        # Per-codec windows: support-space (top-k) and per-shard magnitudes
        # differ from the dense ones, so each family keeps its own; "dense"
        # is the original set, keeping the snapshot's layout.
        self._codec_baselines: Dict[str, Dict[str, RobustBaseline]] = {
            "dense": self._baselines
        }
        self._trust: Dict[int, float] = {}
        self._collapsed: Dict[int, bool] = {}
        self._last_clock: Dict[int, float] = {}
        self._replay_streak: Dict[int, int] = {}
        self._counts: Dict[int, Dict[str, int]] = {}
        self._last_verdict: Dict[int, str] = {}
        # Re-acquaintance amnesty bookkeeping: rounds of last contact and
        # the end of each peer's lenient window (see _observe_contact).
        self._screen_seq = 0
        self._last_seen: Dict[int, int] = {}
        self._amnesty_until: Dict[int, int] = {}
        self._events: List[dict] = []
        # Under the partial view (membership.view) the snapshot lists the
        # tracked peers only (enable_capped_snapshots).
        self._capped_snapshots = False
        self._leaf_starts: Optional[np.ndarray] = None
        self._leaf_sizes: Optional[Tuple[int, ...]] = None
        # Per-clean-exchange recovery gain: trust deficit halves every
        # ewma_half_life clean exchanges.
        self._gain = 1.0 - 0.5 ** (1.0 / max(self.config.ewma_half_life, 1e-6))

    # ------------------------------------------------------------------
    # Wiring
    # ------------------------------------------------------------------

    def attach_scoreboard(self, scoreboard: Any) -> None:
        with self._lock:
            self.scoreboard = scoreboard

    def set_leaf_sizes(self, sizes: Sequence[int]) -> None:
        """Adopt the adapter pytree's leaf boundaries for the per-leaf
        max-abs statistic (resolved lazily against the vector length —
        a mismatch falls back to uniform segments)."""
        with self._lock:
            self._leaf_sizes = tuple(int(s) for s in sizes)
            self._leaf_starts = None  # re-derive at next screen

    # ------------------------------------------------------------------
    # Screening
    # ------------------------------------------------------------------

    def _baselines_for(self, codec: str) -> Dict[str, RobustBaseline]:
        """The baseline windows of ``codec`` (made at its first use)."""
        with self._lock:
            b = self._codec_baselines.get(codec)
            if b is None:
                b = {s: RobustBaseline(self.config.window) for s in BASE_STATS}
                self._codec_baselines[codec] = b
            return b

    def screen(
        self,
        peer: int,
        remote_vec: torch.Tensor,
        remote_clock: float,
        local_vec: torch.Tensor,
        round: Optional[int] = None,
        stats: Optional[Dict[str, float]] = None,
        codec: str = "dense",
        sparse: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        shard: Optional[int] = None,
    ) -> Tuple[str, float, Dict[str, Any]]:
        """Classify one fetched payload: ``(verdict, alpha_scale, stats)``.
        ``alpha_scale`` is the trust damping the transport routes into the
        interpolation (0.0 on a rejection: rejected payloads never merge).
        ``stats`` are the payload's statistics when the caller computed
        them already (:func:`~dpwa_tpu_torch.trust.screen.stats_from_sums`
        over :meth:`leaf_starts`, or over the support for ``sparse``), else
        they are computed here, where the vectors lie.

        ``sparse``: a top-k frame's ``(indices, values)``; the statistics are
        then the support's and ``remote_vec`` (the densified vector) only
        the shape check.  ``shard``: a sharded frame's shard index; the
        caller passes the slices as the vectors.  Either screens against
        ``codec``'s own windows (``f"{codec}:s{shard}"`` for a shard)."""
        cfg = self.config
        lenient = self._observe_contact(peer, round)
        if remote_vec.numel() != local_vec.numel():
            # A well-formed frame of the wrong model: nothing could merge
            # it.  Never amnestied.
            return self._finish(peer, REJECTED, ["shape_mismatch"], {}, round)
        if stats is not None:
            stats = dict(stats)
        elif sparse is not None:
            stats = payload_stats_sparse(local_vec, sparse[0], sparse[1])
        else:
            stats = payload_stats(local_vec, remote_vec, self.leaf_starts(local_vec.numel()))
        if sparse is not None:
            stats["codec"] = codec
        if shard is not None:
            stats["shard"] = int(shard)
        baselines = self._baselines_for(codec if shard is None else f"{codec}:s{int(shard)}")
        with self._lock:
            armed = min(len(b) for b in baselines.values()) >= cfg.min_window
        reasons: List[str] = []
        verdict = TRUSTED
        if armed:
            replay = self._check_replay(peer, float(remote_clock), round)
            if replay is not None:
                reasons.append(replay)
                verdict = REJECTED
            elif stats["cosine"] < cfg.cosine_floor:
                reasons.append("cosine_floor")
                verdict = REJECTED
            elif stats["norm_ratio"] > cfg.norm_ratio_max:
                reasons.append("norm_ratio_max")
                verdict = REJECTED
            else:
                zmax, zstat = 0.0, None
                with self._lock:
                    for s in BASE_STATS:
                        z = baselines[s].zscore(stats[s])
                        if z > zmax:
                            zmax, zstat = z, s
                stats["zmax"] = round_f(zmax)
                if zmax >= cfg.reject_multiplier:
                    reasons.append(f"mad:{zstat}")
                    verdict = REJECTED
                elif zmax >= cfg.mad_multiplier:
                    reasons.append(f"mad:{zstat}")
                    verdict = SUSPECT
        if verdict == REJECTED and lenient:
            # Re-acquaintance amnesty: a peer back from a long silence
            # carries a legitimately diverged replica; merge it damped.
            verdict = SUSPECT
            reasons = ["amnesty:" + r for r in reasons]
            if "amnesty:stale_replay" in reasons:
                # A restarted peer resumes from an older clock.
                with self._lock:
                    self._last_clock[peer] = float(remote_clock)
                    self._replay_streak[peer] = 0
        if verdict != REJECTED:
            self._note_clock(peer, float(remote_clock))
        if verdict == TRUSTED:
            with self._lock:
                for s in BASE_STATS:
                    baselines[s].push(stats[s])
        return self._finish(peer, verdict, reasons, stats, round)

    def _observe_contact(self, peer: int, round: Optional[int]) -> bool:
        """Track contact cadence; returns True while ``peer`` is inside a
        re-acquaintance amnesty window.

        A peer unscreened for more than ``amnesty_gap * (n_peers - 1)``
        rounds (the factor normalizes for the ring's natural pairing
        cadence) — or screened for the very first time — opens an
        ``amnesty_rounds``-round lenient window.  Rounds come from the
        caller's step; raw ``screen`` calls without one fall back to the
        global screen sequence (≈ rounds in a one-exchange-per-round
        loop)."""
        cfg = self.config
        with self._lock:
            self._screen_seq += 1
            now = int(round) if round is not None else self._screen_seq
            last = self._last_seen.get(peer)
            self._last_seen[peer] = now
            if cfg.amnesty_rounds <= 0:
                return False
            gap_limit = cfg.amnesty_gap * max(1, self.n_peers - 1)
            if last is None:
                self._amnesty_until[peer] = now + cfg.amnesty_rounds
            elif cfg.amnesty_gap > 0 and now - last > gap_limit:
                self._amnesty_until[peer] = now + cfg.amnesty_rounds
                self._events.append(
                    {
                        "event": "trust_amnesty",
                        "peer": int(peer),
                        "gap": int(now - last),
                        "round": round,
                    }
                )
            until = self._amnesty_until.get(peer)
            return until is not None and now < until

    def leaf_starts(self, total: int) -> Optional[np.ndarray]:
        """The leaf segment starts for a vector of ``total`` elements (None:
        uniform segments)."""
        with self._lock:
            if self._leaf_starts is not None and int(
                self._leaf_starts[-1]
            ) < total:
                return self._leaf_starts
            if self._leaf_sizes is not None:
                self._leaf_starts = leaf_starts_from_sizes(
                    self._leaf_sizes, total
                )
                return self._leaf_starts
        return None

    def _check_replay(
        self, peer: int, clock: float, round: Optional[int]
    ) -> Optional[str]:
        """Stale-replay detection: this peer already served us a strictly
        newer clock.  A long rejection streak resets the clock base (an
        honest peer that restarted from an old checkpoint must be able
        to re-earn trust instead of being rejected forever)."""
        with self._lock:
            last = self._last_clock.get(peer)
            if last is None or clock >= last - self.config.replay_slack:
                self._replay_streak[peer] = 0
                return None
            streak = self._replay_streak.get(peer, 0) + 1
            self._replay_streak[peer] = streak
            if streak > self.config.window:
                self._last_clock[peer] = clock
                self._replay_streak[peer] = 0
                self._events.append(
                    {
                        "event": "trust_clock_reset",
                        "peer": int(peer),
                        "clock": float(clock),
                        "round": round,
                    }
                )
                return None
            return "stale_replay"

    def _note_clock(self, peer: int, clock: float) -> None:
        with self._lock:
            last = self._last_clock.get(peer)
            if last is None or clock > last:
                self._last_clock[peer] = clock

    def _finish(
        self,
        peer: int,
        verdict: str,
        reasons: List[str],
        stats: Dict[str, Any],
        round: Optional[int],
    ) -> Tuple[str, float, Dict[str, Any]]:
        cfg = self.config
        feed_scoreboard = False
        with self._lock:
            t = self._trust.get(peer, 1.0)
            if verdict == TRUSTED:
                t = t + (1.0 - t) * self._gain
            elif verdict == SUSPECT:
                t = t * cfg.suspect_decay
            else:
                t = t * cfg.reject_decay
            self._trust[peer] = t
            c = self._counts.setdefault(
                peer, {"screened": 0, "trusted": 0, "suspect": 0,
                       "rejected": 0}
            )
            c["screened"] += 1
            c[verdict] += 1
            self._last_verdict[peer] = verdict
            collapsed = t < cfg.quarantine_trust
            was = self._collapsed.get(peer, False)
            self._collapsed[peer] = collapsed
            if collapsed:
                feed_scoreboard = True
                if not was:
                    self._events.append(
                        {
                            "event": "trust_collapsed",
                            "peer": int(peer),
                            "trust": round_f(t),
                            "round": round,
                        }
                    )
            elif was and t >= 0.995:
                self._collapsed[peer] = False
                self._events.append(
                    {
                        "event": "trust_recovered",
                        "peer": int(peer),
                        "trust": round_f(t),
                        "round": round,
                    }
                )
            elif was:
                # Still digging out: stays flagged until full recovery so
                # the recovery event marks the round full alpha returned.
                self._collapsed[peer] = True
            scoreboard = self.scoreboard
        if feed_scoreboard and scoreboard is not None:
            # Outside the lock: record_probe takes the scoreboard's own
            # lock and may re-enter quarantine accounting.
            scoreboard.record_probe(peer, Outcome.UNTRUSTED, round=round)
        scale = 0.0 if verdict == REJECTED else self.alpha_scale(peer)
        out = dict(stats)
        out["trust"] = round_f(self._trust[peer])
        if reasons:
            out["reasons"] = reasons
        return verdict, scale, out

    # ------------------------------------------------------------------
    # Eviction (the membership plane's evict listener)
    # ------------------------------------------------------------------

    def evict_peer(self, peer: int) -> None:
        """Drop every per-peer record for a membership-evicted peer.

        The global baseline windows stay: they describe the
        honest ring, not the departed peer.  A rejoiner rematerializes
        at trust 1.0 and immediately opens a first-contact amnesty
        window (``_observe_contact`` sees it as never screened), which
        is exactly the cold-start posture a genuinely new peer gets."""
        with self._lock:
            for d in (
                self._trust,
                self._collapsed,
                self._last_clock,
                self._replay_streak,
                self._counts,
                self._last_verdict,
                self._last_seen,
                self._amnesty_until,
            ):
                d.pop(peer, None)

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------

    def trust(self, peer: int) -> float:
        with self._lock:
            return self._trust.get(peer, 1.0)

    def enable_capped_snapshots(self) -> None:
        """Make :meth:`snapshot` list the tracked peers only (the transport
        calls this when ``membership.view`` is on)."""
        with self._lock:
            self._capped_snapshots = True

    def is_collapsed(self, peer: int) -> bool:
        """Whether ``peer``'s trust has collapsed to quarantine: the partial
        view's cap protector (a collapsed verdict expires through the
        streak, never because the peer went cold in the LRU)."""
        with self._lock:
            return bool(self._collapsed.get(peer, False))

    def tracked_peers(self) -> List[int]:
        """Every peer with state in any per-peer map: the residency the
        partial view's ``state_cap`` bounds."""
        with self._lock:
            keys = (set(self._trust) | set(self._collapsed) | set(self._last_clock)
                    | set(self._replay_streak) | set(self._counts) | set(self._last_verdict)
                    | set(self._last_seen) | set(self._amnesty_until))
            keys.discard(self.me)
            return sorted(keys)

    def alpha_scale(self, peer: int) -> float:
        """Merge damping for ``peer``: ``trust ** damping``, snapped to
        exactly 1.0 near full trust so honest rings merge bit-identically
        to a trust-disabled run."""
        with self._lock:
            t = self._trust.get(peer, 1.0)
        if t >= 0.995:
            return 1.0
        return float(t ** self.config.damping)

    def pop_events(self) -> List[dict]:
        with self._lock:
            events, self._events = self._events, []
            return events

    def snapshot(self) -> dict:
        """JSON-ready trust view: per-peer trust/verdict/counters plus
        the baseline fill state (merged into ``health_snapshot`` and the
        ``/trust`` endpoint route)."""
        with self._lock:
            fill = min(len(b) for b in self._baselines.values())
            peers = {}
            # Under the partial view only tracked peers have state to report.
            universe = (sorted(set(self._trust) | set(self._counts) | set(self._last_verdict))
                        if self._capped_snapshots else range(self.n_peers))
            for p in universe:
                if p == self.me:
                    continue
                c = self._counts.get(p, {})
                peers[p] = {
                    "trust": round_f(self._trust.get(p, 1.0)),
                    "trust_verdict": self._last_verdict.get(p),
                    "trust_screened": c.get("screened", 0),
                    "trust_damped": c.get("suspect", 0),
                    "trust_rejected": c.get("rejected", 0),
                }
            out = {
                "enabled": True,
                "armed": fill >= self.config.min_window,
                "window_fill": fill,
                "baselines": {s: b.snapshot() for s, b in sorted(self._baselines.items())},
                "peers": peers,
            }
            if len(self._codec_baselines) > 1:
                # The codecs' windows ride a key of their own, so a dense
                # run's snapshot stays as it was.
                out["codec_baselines"] = {
                    c: {s: b.snapshot() for s, b in sorted(bl.items())}
                    for c, bl in sorted(self._codec_baselines.items()) if c != "dense"
                }
            return out


def round_f(x: float, digits: int = 4) -> float:
    return round(float(x), digits)


def register_metrics(registry, manager: TrustManager) -> None:
    """The content-trust plane on a ``/metrics`` registry."""
    from dpwa_tpu_torch.obs.prometheus import Family

    def collect():
        snap = manager.snapshot()
        trust = Family("dpwa_trust_score", "gauge",
                       "Per-peer content-trust EWMA (1.0 = fully trusted)")
        rejected = Family("dpwa_trust_rejected_total", "counter",
                          "Payloads rejected by the trust screen per peer")
        damped = Family("dpwa_trust_damped_total", "counter",
                        "Payloads merged with damped alpha per peer")
        for p, info in sorted((snap.get("peers") or {}).items()):
            labels = {"peer": p}
            trust.sample(info.get("trust"), labels)
            rejected.sample(info.get("trust_rejected"), labels)
            damped.sample(info.get("trust_damped"), labels)
        return [
            trust,
            rejected,
            damped,
            Family("dpwa_trust_armed", "gauge",
                   "1 once the robust baselines have enough history to arm").sample(
                snap.get("armed")),
        ]

    registry.register(collect)
