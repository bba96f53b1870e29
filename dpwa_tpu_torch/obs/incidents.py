"""The incident plane: online detectors and a cross-plane correlator (the
port of :mod:`dpwa_tpu.obs.incidents`, record for record, on flat rings).

It runs on the training thread once a round over what the other planes
already produce (fetch outcomes, scoreboard transitions, membership and
trust events, the sketch board's ``rel_rms``, the round's wall time) and
writes two record kinds that ``tools/schema_check.py`` freezes:

- ``record: "alert"``: one detector firing (``kind``, ``plane``,
  ``severity``, ``value``/``threshold``, the implicated ``peer``/``peers``),
  on the rising edge only: a condition that stays true supports the open
  incident silently;
- ``record: "incident"``: the correlator's view, open then update then
  resolved.  One incident is open at a time; concurrent alerts fold into it
  and its class upgrades to the highest-priority evidence seen
  (:data:`KIND_PRIORITY`).  It resolves after ``incident_resolve_after``
  quiet rounds with every implicated peer healthy again.

The detectors (thresholds in :class:`~dpwa_tpu_torch.config.ObsConfig`):
``peer_failure`` (a streak of hard fetch failures from one peer),
``trust_burst`` (untrusted or poisoned payloads from one peer inside the
window), ``straggler`` (busy or slow outcomes inside the window, or a peer
the scoreboard holds degraded), ``partition`` and ``partition_flap`` (the
membership plane's below-quorum entries), ``state_storm`` (quarantine and
degrade transitions inside the window), ``slo_burn`` (rounds slower than a
factor of the rolling median), ``conv_stall`` (``rel_rms`` not improving)
and ``staleness_storm`` (the async loop's bounded-staleness drops).  All but
the last two wall-clock and float detectors are keyed on round counters and
outcomes, so replays of a seed fire alike.

Given the hierarchical topology, a partition whose cut is exactly a union
of whole islands is classified ``island_partition`` instead of the generic
``partition``; ``leader_failover`` (a leader board's succession) names the
old leader and carries the new term.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Set

from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.metrics import MetricsLogger

# Hard fetch failures: evidence of a dead process or path.
_HARD = (Outcome.TIMEOUT, Outcome.REFUSED, Outcome.SHORT_READ, Outcome.CORRUPT)
# Content (byzantine) evidence: the guard or the trust screen fired.
_BYZ = (Outcome.POISONED, Outcome.UNTRUSTED)
# Load evidence: the soft outcomes the scoreboard degrades on.
_SOFT = (Outcome.BUSY, Outcome.SLOW)

# alert kind -> (emitting plane, incident class, severity).
ALERT_KINDS: Dict[str, tuple] = {
    "partition": ("membership", "partition", "critical"),
    "partition_flap": ("membership", "partition", "critical"),
    "island_partition": ("membership", "island_partition", "critical"),
    "leader_failover": ("hier", "leader_failover", "critical"),
    "trust_burst": ("trust", "byzantine", "critical"),
    "peer_failure": ("health", "peer_down", "critical"),
    "straggler": ("flowctl", "straggler", "warning"),
    "state_storm": ("health", "state_storm", "critical"),
    "slo_burn": ("obs", "slo_burn", "warning"),
    "conv_stall": ("obs", "conv_stall", "warning"),
    "staleness_storm": ("async", "staleness_storm", "warning"),
}

# The incident classes in root-cause priority (first wins); the wall-clock
# detectors rank last, so timing jitter never reclassifies a chaos incident.
KIND_PRIORITY = (
    "island_partition", "partition", "byzantine", "leader_failover",
    "peer_down", "straggler", "staleness_storm", "state_storm",
    "slo_burn", "conv_stall",
)

_SEV_RANK = {"warning": 1, "critical": 2}

# Bounded memories of alerts and records.
_ALERT_MEMORY = 256
_RECORD_MEMORY = 1024
_CLOSED_MEMORY = 64
_SLO_BASELINE = 64


def _format_me(path: str, me: int) -> str:
    """``{me}`` substituted, so one shared config names per-node files."""
    try:
        return path.format(me=me)
    except (KeyError, IndexError, ValueError):
        return path


class IncidentPlane:
    """A node's detectors and correlator.  ``observe_round`` runs on the
    training thread; ``snapshot`` is read by healthz and metrics threads,
    so the correlator's outputs are under a lock."""

    def __init__(self, me: int, n_peers: int, cfg, path: Optional[str] = None, topology=None):
        self.me = int(me)
        self.n_peers = int(n_peers)
        self.cfg = cfg
        # The hier Topology (None on a flat ring) arms island_partition.
        self.topology = topology
        if path is None:
            path = cfg.incident_path
        self._logger = MetricsLogger(path=_format_me(path, self.me)) if path else None
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        # -- detector state (training thread) ---------------------------
        self._hard_streak: Dict[int, int] = {}
        self._byz_steps: Dict[int, deque] = {}
        self._byz_live: Set[int] = set()
        self._soft_steps: Dict[int, deque] = {}
        self._soft_live: Set[int] = set()
        self._prev_transitions: Dict[int, int] = {}
        self._storm_steps: deque = deque()
        self._storm_live = False
        self._partition_steps: deque = deque()
        self._partition_live = False
        self._flap_live = False
        self._rel: deque = deque(maxlen=max(2, cfg.incident_stall_window))
        self._stall_live = False
        self._stale_steps: deque = deque()
        self._stale_live = False
        self._wall: deque = deque(maxlen=_SLO_BASELINE)
        self._burn = 0
        self._slo_live = False
        # -- correlator outputs (shared with the readers) ---------------
        self._alert_total: Dict[str, int] = {}
        self._alerts: deque = deque(maxlen=_ALERT_MEMORY)
        self._records: deque = deque(maxlen=_RECORD_MEMORY)
        self._open: Optional[dict] = None
        self._closed: deque = deque(maxlen=_CLOSED_MEMORY)
        self._opened_total = 0
        self._resolved_total = 0
        self._last_step = -1

    # -- the detectors (training thread) ---------------------------------
    def observe_round(
        self,
        step: int,
        *,
        outcome: Optional[str] = None,
        peer: Optional[int] = None,
        board: Optional[dict] = None,
        events: Sequence[dict] = (),
        rel_rms: Optional[float] = None,
        wall_s: Optional[float] = None,
        partition_state: Optional[str] = None,
        component: Optional[Sequence[int]] = None,
        stale_peers: Sequence[int] = (),
    ) -> dict:
        """Feed one round's evidence: ``outcome``/``peer`` the round's fetch
        (None on a skipped round), ``board`` the scoreboard's snapshot,
        ``events`` the round's membership and trust events, ``rel_rms`` the
        sketch board's, ``wall_s`` the entry-to-entry round time,
        ``partition_state``/``component`` the membership view and
        ``stale_peers`` the peers whose frames the async loop dropped as
        stale.  Returns ``{"alerts": [kinds], "opened": bool}`` (an open is
        the flight recorder's dump trigger)."""
        cfg = self.cfg
        step = int(step)
        fired: List[dict] = []
        # kind -> the implicated peers still supported this round.
        active: Dict[str, Set[int]] = {}
        window = cfg.incident_window

        def _fire(kind: str, peers: Set[int], value: float, threshold: float,
                  win: Optional[int] = None) -> None:
            plane, _, severity = ALERT_KINDS[kind]
            alert: Dict[str, Any] = {
                "record": "alert", "kind": kind, "severity": severity,
                "plane": plane, "value": round(float(value), 6),
                "threshold": round(float(threshold), 6),
            }
            if win is not None:
                alert["window"] = int(win)
            if len(peers) == 1:
                alert["peer"] = next(iter(peers))
            elif peers:
                alert["peers"] = sorted(peers)
            fired.append(alert)

        # 1. Streaks and bursts of this round's partner's outcomes.
        if peer is not None and peer != self.me and outcome is not None:
            if outcome == Outcome.SUCCESS:
                self._hard_streak[peer] = 0
            elif outcome in _HARD:
                s = self._hard_streak.get(peer, 0) + 1
                self._hard_streak[peer] = s
                if s == cfg.incident_fail_streak:
                    _fire("peer_failure", {peer}, s, cfg.incident_fail_streak)
            if outcome in _BYZ:
                self._byz_steps.setdefault(peer, deque()).append(step)
            if outcome in _SOFT:
                self._soft_steps.setdefault(peer, deque()).append(step)
        for p, s in self._hard_streak.items():
            if s >= cfg.incident_fail_streak:
                active.setdefault("peer_failure", set()).add(p)
        for kind, steps, live, thr in (
            ("trust_burst", self._byz_steps, self._byz_live, cfg.incident_trust_burst),
            ("straggler", self._soft_steps, self._soft_live, cfg.incident_soft_streak),
        ):
            for p, dq in steps.items():
                while dq and dq[0] <= step - window:
                    dq.popleft()
                if len(dq) >= thr:
                    active.setdefault(kind, set()).add(p)
                    if p not in live:
                        live.add(p)
                        _fire(kind, {p}, len(dq), thr, window)
                else:
                    live.discard(p)

        # 1b. A storm of bounded-staleness drops (the async round loop).
        for p in stale_peers:
            self._stale_steps.append((step, int(p)))
        while self._stale_steps and self._stale_steps[0][0] <= step - window:
            self._stale_steps.popleft()
        n_stale = len(self._stale_steps)
        if n_stale >= cfg.incident_stale_storm:
            peers = {p for _, p in self._stale_steps}
            active.setdefault("staleness_storm", set()).update(peers)
            if not self._stale_live:
                self._stale_live = True
                _fire("staleness_storm", peers, n_stale, cfg.incident_stale_storm, window)
        else:
            self._stale_live = False

        # 2. Scoreboard transition storm, and peers held unhealthy.
        sticky: Set[int] = set()
        if board is not None:
            for p, info in board.get("peers", {}).items():
                p = int(p)
                c = int(info.get("quarantines", 0) or 0) + int(info.get("degrades", 0) or 0)
                prev = self._prev_transitions.get(p, 0)
                if c > prev:
                    for _ in range(c - prev):
                        self._storm_steps.append((step, p))
                self._prev_transitions[p] = c
                state = info.get("state")
                if state in ("quarantined", "degraded"):
                    sticky.add(p)
                if state == "degraded":
                    # A degraded peer supports the straggler alert even on
                    # rounds we did not fetch from it.
                    active.setdefault("straggler", set()).add(p)
            while self._storm_steps and self._storm_steps[0][0] <= step - window:
                self._storm_steps.popleft()
            n_trans = len(self._storm_steps)
            if n_trans >= cfg.incident_storm_threshold:
                peers = {p for _, p in self._storm_steps}
                active.setdefault("state_storm", set()).update(peers)
                if not self._storm_live:
                    self._storm_live = True
                    _fire("state_storm", peers, n_trans, cfg.incident_storm_threshold, window)
            else:
                self._storm_live = False

        # 3. Membership partitions, and trust collapses as support.
        members = set(int(p) for p in component) if component else None
        others = {p for p in range(self.n_peers)
                  if p != self.me and (members is None or p not in members)}
        for ev in events:
            kind = ev.get("event")
            if kind == "partition_entered":
                self._partition_steps.append(step)
                self._partition_live = True
                comp = ev.get("component")
                cut = {p for p in range(self.n_peers)
                       if p != self.me and comp is not None and p not in comp}
                cut_islands = self._island_aligned_cut(cut)
                if cut_islands is not None:
                    # The cut is whole islands: the island-scoped class, in
                    # place of the generic one on the same evidence.
                    _fire("island_partition", cut, len(cut_islands),
                          float(ev.get("quorum_fraction", 0.0)))
                else:
                    _fire("partition", cut or others, len(comp) if comp is not None else 0,
                          float(ev.get("quorum_fraction", 0.0)))
            elif kind == "partition_healed":
                self._partition_live = False
            elif kind == "leader_failover":
                # The old leader is the implicated peer; the value is the new
                # term (the digest's leader_term column).
                peers = set()
                if ev.get("old_leader") is not None:
                    peers.add(int(ev["old_leader"]))
                _fire("leader_failover", peers, float(ev.get("term", 0)), 1.0)
            elif kind == "trust_collapsed":
                p = ev.get("peer")
                if p is not None:
                    active.setdefault("trust_burst", set()).add(int(p))
        if partition_state == "degraded":
            self._partition_live = True
        elif partition_state == "ok" and not any(
            ev.get("event") == "partition_entered" for ev in events
        ):
            self._partition_live = False
        if self._partition_live:
            active.setdefault("partition", set()).update(others)
        while self._partition_steps and self._partition_steps[0] <= step - 4 * window:
            self._partition_steps.popleft()
        if len(self._partition_steps) >= 2:
            if not self._flap_live:
                self._flap_live = True
                _fire("partition_flap", others, len(self._partition_steps), 2, 4 * window)
        else:
            self._flap_live = False

        # 4. A convergence stall over the sketch's rel_rms.
        if rel_rms is not None and rel_rms > 0.0:
            self._rel.append(float(rel_rms))
            if len(self._rel) == self._rel.maxlen:
                first, last = self._rel[0], self._rel[-1]
                stalled = (
                    min(self._rel) > cfg.incident_stall_min_rel
                    and last > first * (1.0 - cfg.incident_stall_improve)
                )
                if stalled:
                    active.setdefault("conv_stall", set())
                    if not self._stall_live:
                        self._stall_live = True
                        _fire("conv_stall", set(), last, cfg.incident_stall_min_rel,
                              cfg.incident_stall_window)
                else:
                    self._stall_live = False

        # 5. Round wall time against its rolling median (the SLO burn).
        if wall_s is not None and wall_s >= 0.0:
            if len(self._wall) >= cfg.incident_slo_warmup:
                base = sorted(self._wall)
                med = base[len(base) // 2]
                if med > 0.0 and wall_s > cfg.incident_slo_factor * med:
                    self._burn += 1
                else:
                    self._burn = 0
                if self._burn >= cfg.incident_slo_rounds:
                    active.setdefault("slo_burn", set())
                    if not self._slo_live:
                        self._slo_live = True
                        _fire("slo_burn", set(), wall_s, cfg.incident_slo_factor * med,
                              cfg.incident_slo_rounds)
                else:
                    self._slo_live = False
            self._wall.append(float(wall_s))

        with self._lock:
            self._last_step = step
            t = round(time.perf_counter() - self._t0, 4)
            for alert in fired:
                self._alert_total[alert["kind"]] = self._alert_total.get(alert["kind"], 0) + 1
                full = dict(alert)
                full["step"] = step
                full["t"] = t
                self._alerts.append(full)
                self._records.append(full)
                if self._logger is not None:
                    self._logger.log(step, _t=t, **alert)
            opened = self._fold(step, t, fired, active, sticky)
        return {"alerts": [a["kind"] for a in fired], "opened": opened}

    def _island_aligned_cut(self, cut) -> Optional[list]:
        """The islands a cut consists of when it is exactly a union of whole
        islands; None otherwise (no topology, an empty cut, or a cut that
        splits an island).  ``me``'s own island is never cut."""
        topo = self.topology
        if topo is None or not cut:
            return None
        cut_islands = []
        covered: Set[int] = set()
        for g in range(topo.n_islands):
            members = set(topo.members_of(g))
            if self.me in members:
                continue
            inside = members & cut
            if not inside:
                continue
            if inside != members:
                return None  # the island straddles the cut
            cut_islands.append(g)
            covered |= members
        if covered != set(cut):
            return None
        return cut_islands

    # -- the correlator (self._lock held) --------------------------------
    @staticmethod
    def _rank(kind: str) -> int:
        try:
            return KIND_PRIORITY.index(kind)
        except ValueError:
            return len(KIND_PRIORITY)

    def _fold(self, step: int, t: float, fired: List[dict], active: Dict[str, Set[int]],
              sticky: Set[int]) -> bool:
        """Fold this round's alerts and support into the open incident,
        opening, updating or resolving it; True when one opened now."""
        inc = self._open
        if inc is None:
            if not fired:
                return False
            inc = self._open = {
                "id": f"{self.me}:{step}",
                "kind": "conv_stall",  # a placeholder, upgraded below
                "severity": "warning",
                "peers": set(),
                "alerts": 0,
                "alert_kinds": set(),
                "opened_step": step,
                "last_evidence_step": step,
            }
            self._opened_total += 1
            self._merge_alerts(inc, fired)
            self._emit_incident(inc, "open", step, t)
            return True
        changed = self._merge_alerts(inc, fired)
        if fired or active or (sticky & inc["peers"]):
            inc["last_evidence_step"] = step
        if changed:
            self._emit_incident(inc, "update", step, t)
        elif step - inc["last_evidence_step"] >= self.cfg.incident_resolve_after:
            self._open = None
            self._resolved_total += 1
            self._emit_incident(inc, "resolved", step, t)
            pub = self._public(inc, "resolved")
            pub["resolved_step"] = step
            self._closed.append(pub)
        return False

    def _merge_alerts(self, inc: dict, fired: List[dict]) -> bool:
        changed = False
        for alert in fired:
            inc["alerts"] += 1
            inc["alert_kinds"].add(alert["kind"])
            _, cls, severity = ALERT_KINDS[alert["kind"]]
            if self._rank(cls) < self._rank(inc["kind"]):
                inc["kind"] = cls
                changed = True
            if _SEV_RANK.get(severity, 0) > _SEV_RANK.get(inc["severity"], 0):
                inc["severity"] = severity
                changed = True
            peers = set(alert.get("peers") or ())
            if "peer" in alert:
                peers.add(alert["peer"])
            if peers - inc["peers"]:
                inc["peers"] |= peers
                changed = True
        return changed

    def _emit_incident(self, inc: dict, status: str, step: int, t: float) -> None:
        rec: Dict[str, Any] = {
            "record": "incident",
            "id": inc["id"],
            "status": status,
            "kind": inc["kind"],
            "severity": inc["severity"],
            "peers": sorted(inc["peers"]),
            "alerts": inc["alerts"],
            "opened_step": inc["opened_step"],
            "me": self.me,
        }
        if status == "resolved":
            rec["resolved_step"] = step
        full = dict(rec)
        full["step"] = step
        full["t"] = t
        self._records.append(full)
        if self._logger is not None:
            self._logger.log(step, _t=t, **rec)

    def _public(self, inc: dict, status: str) -> dict:
        return {
            "id": inc["id"],
            "status": status,
            "kind": inc["kind"],
            "severity": inc["severity"],
            "peers": sorted(inc["peers"]),
            "alerts": inc["alerts"],
            "alert_kinds": sorted(inc["alert_kinds"]),
            "opened_step": inc["opened_step"],
            "last_evidence_step": inc["last_evidence_step"],
        }

    # -- the readers -------------------------------------------------------
    def snapshot(self) -> dict:
        """The JSON-ready incident view: the ``/incidents`` route and the
        ``incidents`` key of ``health_snapshot``."""
        with self._lock:
            return {
                "me": self.me,
                "step": self._last_step,
                "open": [self._public(self._open, "open")] if self._open is not None else [],
                "closed": list(self._closed),
                "opened_total": self._opened_total,
                "resolved_total": self._resolved_total,
                "alerts_total": dict(self._alert_total),
                "recent_alerts": list(self._alerts)[-16:],
            }

    def pop_records(self) -> List[dict]:
        """Drain the alert and incident records held in memory."""
        with self._lock:
            out = list(self._records)
            self._records.clear()
        return out

    def close(self) -> None:
        if self._logger is not None:
            self._logger.close()
            self._logger = None


def register_metrics(registry, plane: IncidentPlane) -> None:
    """Prometheus collectors of the incident plane (scrape-time reads of
    :meth:`IncidentPlane.snapshot`)."""
    from dpwa_tpu_torch.obs.prometheus import Family

    def _collect():
        snap = plane.snapshot()
        alerts = Family("dpwa_alerts_total", "counter", "Detector alerts fired, by alert kind.")
        for kind, n in sorted(snap["alerts_total"].items()):
            alerts.sample(n, {"kind": kind})
        sev = 0
        for inc in snap["open"]:
            sev = max(sev, _SEV_RANK.get(inc["severity"], 0))
        return [
            alerts,
            Family("dpwa_incidents_opened_total", "counter",
                   "Incidents opened by the correlator.").sample(snap["opened_total"]),
            Family("dpwa_incidents_resolved_total", "counter",
                   "Incidents resolved by the correlator.").sample(snap["resolved_total"]),
            Family("dpwa_incidents_open", "gauge",
                   "Incidents currently open (0 or 1).").sample(len(snap["open"])),
            Family("dpwa_incident_severity", "gauge",
                   "Max open-incident severity (0=none 1=warning 2=critical).").sample(sev),
        ]

    registry.register(_collect)
