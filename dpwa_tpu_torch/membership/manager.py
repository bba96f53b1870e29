"""Membership manager: merged epidemic view, partition state, heal advice
(the port of :mod:`dpwa_tpu.membership.manager`, its global view).

One instance per local node, attached to its
:class:`~dpwa_tpu_torch.health.scoreboard.Scoreboard`.  The manager owns
what the scoreboard alone cannot provide:

- the **merged view**: every peer's last-known disseminated state and
  incarnation (gossip claims folded with the SWIM rules of
  :mod:`dpwa_tpu_torch.membership.digest`), overlaid with local fetch
  evidence when a digest is encoded;
- the node's own **incarnation**, bumped when a digest claims *this* node
  is suspect, quarantined or dead at an incarnation at least as fresh as
  ours: the refutation that clears a falsely suspected live node;
- **partition bookkeeping**: the connected component the view implies,
  quorum and degraded mode, eviction of peers held dead, and the heal
  advice the adapter turns into a state merge.

Every decision counts gossip rounds; there is no wall clock, so equal
outcome sequences give equal event streams, in either package.  Not
ported: the partial view (``membership.view``), the hierarchical digest's
leader board (a ``topology:`` block is refused by the config) and
``register_metrics``.

Thread safety: state changes take the internal lock.  Scoreboard calls are
made outside it (the scoreboard's snapshot calls back into
:meth:`view_snapshot`; holding both locks in opposite orders would
deadlock).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Set

from dpwa_tpu_torch.config import MembershipConfig
from dpwa_tpu_torch.health.scoreboard import PeerState, Scoreboard
from dpwa_tpu_torch.membership.digest import (
    ALIVE,
    DEAD,
    QUARANTINED,
    STATE_NAMES,
    SUSPECT,
    Digest,
    MemberEntry,
    decode_digest,
    encode_digest,
    merge_entry,
)

# A peer back from unreachable stays in the pending-heal pool this many
# rounds while waiting for enough of its component to follow; after that it
# is an isolated rejoin (recovery's re-sync advice covers it), not a heal.
RETURN_WINDOW_ROUNDS = 8


class MembershipManager:
    """Merged membership view and partition/heal state for one node."""

    def __init__(
        self,
        n_peers: int,
        me: int,
        scoreboard: Scoreboard,
        config: Optional[MembershipConfig] = None,
        seed: int = 0,
    ):
        self.config = config if config is not None else MembershipConfig()
        self.n_peers = n_peers
        self.me = me
        self.seed = seed
        self.scoreboard = scoreboard
        self.partial = None  # the partial view is not ported
        self._lock = threading.Lock()
        self.incarnation = 0
        self._view: Dict[int, MemberEntry] = {}
        self._events: List[dict] = []
        self._heal_advice: Optional[dict] = None
        self._component: Set[int] = set(range(n_peers))
        self._degraded = False
        # Peers recently back from unreachable: peer -> round it returned.
        self._returned_pending: Dict[int, int] = {}
        # Round the combined view first held each peer DEAD, and the peers
        # since evicted (pruned from the other planes, left off the digest).
        self._dead_since: Dict[int, int] = {}
        self._evicted: Set[int] = set()
        # Called (outside the lock) with each evicted peer.
        self._evict_listeners: List[Callable[[int], None]] = []
        self._round = 0
        scoreboard.attach_membership(self)

    def add_evict_listener(self, fn: Callable[[int], None]) -> None:
        """Register a callback fired once per peer eviction."""
        with self._lock:
            self._evict_listeners.append(fn)

    # -- local evidence -> digest states --------------------------------
    def _local_state(self, peer: int) -> int:
        """This node's own fetch evidence about ``peer`` as a digest state."""
        sb_state = self.scoreboard.state(peer)
        if sb_state == PeerState.QUARANTINED:
            streak = self.scoreboard.quarantine_streak(peer)
            return DEAD if streak >= self.config.dead_after_quarantines else QUARANTINED
        if sb_state in (PeerState.SUSPECT, PeerState.DEGRADED):
            # DEGRADED (load, not death) disseminates as SUSPECT: receivers
            # adopt only QUARANTINED-or-worse claims.
            return SUSPECT
        return ALIVE

    def _combined(self, peer: int) -> MemberEntry:
        """The gossip view overlaid with local evidence (max severity)."""
        view = self._view.get(peer, MemberEntry())
        return MemberEntry(
            state=max(view.state, self._local_state(peer)),
            incarnation=view.incarnation,
            suspicion=max(view.suspicion, self.scoreboard.suspicion(peer)),
        )

    def _combined_all(self) -> Dict[int, MemberEntry]:
        """Every tracked peer's combined entry (scoreboard reads: call
        without the lock)."""
        with self._lock:
            evicted = set(self._evicted)
        return {
            p: self._combined(p)
            for p in range(self.n_peers)
            if p != self.me and p not in evicted
        }

    # -- digest I/O (the transport's publish and fetch paths) -----------
    def encode(self, round: int) -> bytes:
        """The digest this round's published frame carries: every peer but
        the evicted ones, and this node ALIVE at its incarnation."""
        entries = self._combined_all()
        with self._lock:
            self._round = max(self._round, int(round))
            entries[self.me] = MemberEntry(state=ALIVE, incarnation=self.incarnation, suspicion=0.0)
            return encode_digest(Digest(origin=self.me, round=int(round), entries=entries))

    def merge(self, blob: Optional[bytes], round: Optional[int] = None) -> None:
        """Fold a received digest into the view (None, or bytes that are
        not a digest, change nothing: a peer without a trailer is the old
        wire)."""
        if not blob:
            return
        digest = decode_digest(blob)
        if digest is None:
            return
        r = int(round) if round is not None else self._round
        readmits: List[int] = []
        adopts: List[int] = []
        events: List[dict] = []
        with self._lock:
            self._round = max(self._round, r)
            for peer, claim in sorted(digest.entries.items()):
                if peer >= self.n_peers:
                    continue
                if peer == self.me:
                    # Refutation: someone thinks we are sick at an
                    # incarnation as fresh as ours; outbid them.
                    if claim.state > ALIVE and claim.incarnation >= self.incarnation:
                        self.incarnation = claim.incarnation + 1
                        events.append({
                            "event": "refutation",
                            "peer": self.me,
                            "claimed_state": STATE_NAMES[claim.state],
                            "claimed_by": digest.origin,
                            "incarnation": self.incarnation,
                        })
                    continue
                local = self._view.get(peer, MemberEntry())
                merged, changed = merge_entry(local, claim)
                if not changed:
                    continue
                self._view[peer] = merged
                fresher = merged.incarnation > local.incarnation
                if merged.state >= QUARANTINED and local.state < QUARANTINED:
                    adopts.append(peer)  # the ring agrees the peer is down
                elif fresher and merged.state == ALIVE:
                    readmits.append(peer)  # the peer refuted a suspicion
            self._events.extend(events)
        for peer in adopts:
            self.scoreboard.adopt_quarantine(peer, round=r)
        refuted: List[dict] = []
        for peer in readmits:
            if self.scoreboard.readmit(peer, round=r):
                refuted.append({
                    "event": "peer_refuted",
                    "peer": peer,
                    "incarnation": self._view[peer].incarnation,
                })
        if refuted:
            with self._lock:
                for rec in refuted:
                    peer = rec["peer"]
                    self._dead_since.pop(peer, None)
                    if peer in self._evicted:
                        # A rejoiner outbid its own dead claim.
                        self._evicted.discard(peer)
                        self._events.append({
                            "event": "peer_rejoined",
                            "peer": peer,
                            "via": "refutation",
                            "incarnation": self._view[peer].incarnation,
                        })
                self._events.extend(refuted)

    # -- the round boundary: component, quorum, heal --------------------
    def end_round(self, step: int) -> None:
        """Recompute the component after this round's exchange, age dead
        claims toward eviction, and leave heal advice when enough of the
        ring came back."""
        combined = self._combined_all()
        component = {self.me} | {p for p, e in combined.items() if e.state <= SUSPECT}
        dead_now = {p for p, e in combined.items() if e.state >= DEAD}
        step = int(step)
        events: List[dict] = []
        evictions: List[int] = []
        with self._lock:
            self._round = max(self._round, step)
            if self.config.dead_gossip_rounds > 0:
                for p in sorted(dead_now):
                    since = self._dead_since.setdefault(p, step)
                    if step - since >= self.config.dead_gossip_rounds:
                        evictions.append(p)
                for p in sorted(self._dead_since):
                    if p not in dead_now:
                        del self._dead_since[p]
                for p in evictions:
                    self._evicted.add(p)
                    del self._dead_since[p]
                    events.append({
                        "event": "peer_dead",
                        "peer": p,
                        "dead_rounds": self.config.dead_gossip_rounds,
                        "evicted": sorted(self._evicted),
                    })
            # Quorum and heal fractions run over the ring that still exists.
            alive_universe = max(1, self.n_peers - len(self._evicted))
            prev = self._component
            if component != prev:
                events.append({
                    "event": "component_changed",
                    "component": sorted(component),
                    "size": len(component),
                    "component_id": min(component),
                })
            for p in component - prev:
                self._returned_pending[p] = step
            self._returned_pending = {
                p: r
                for p, r in sorted(self._returned_pending.items())
                if p in component and step - r <= RETURN_WINDOW_ROUNDS
            }
            degraded = len(component) / alive_universe < self.config.quorum_fraction
            if degraded and not self._degraded:
                events.append({
                    "event": "partition_entered",
                    "component": sorted(component),
                    "size": len(component),
                    "quorum_fraction": self.config.quorum_fraction,
                })
            healed = False
            pending = set(self._returned_pending)
            if pending and len(pending) / alive_universe >= self.config.reconcile_min_fraction:
                healed = True
                weight = min(self.config.max_heal_weight, len(pending) / max(1, len(component)))
                self._heal_advice = {"returning": sorted(pending), "weight": weight, "step": step}
                self._returned_pending = {}
            if healed or (self._degraded and not degraded):
                events.append({
                    "event": "partition_healed",
                    "component": sorted(component),
                    "size": len(component),
                    "returning": sorted(pending) if healed else [],
                })
            self._component = component
            self._degraded = degraded
            self._events.extend(events)
            listeners = list(self._evict_listeners)
        # Prune the other planes outside our lock (theirs-before-ours).
        for p in evictions:
            self.scoreboard.evict_peer(p, round=step)
            for fn in listeners:
                fn(p)

    def on_peer_returned(self, peer: int, round: Optional[int] = None) -> None:
        """Direct probe evidence that an evicted peer is back.  Called by
        ``Scoreboard.record_probe`` with the scoreboard lock held: must not
        call back into the scoreboard.  Clears the eviction and downgrades
        the stale DEAD entry to ALIVE at the same incarnation."""
        with self._lock:
            if peer not in self._evicted:
                return
            self._evicted.discard(peer)
            self._dead_since.pop(peer, None)
            entry = self._view.get(peer)
            if entry is not None and entry.state > ALIVE:
                self._view[peer] = MemberEntry(
                    state=ALIVE, incarnation=entry.incarnation, suspicion=0.0
                )
            self._events.append({
                "event": "peer_rejoined",
                "peer": peer,
                "via": "probe",
                "round": int(round) if round is not None else None,
            })

    def evicted_peers(self) -> List[int]:
        """Currently evicted peers, ascending."""
        with self._lock:
            return sorted(self._evicted)

    # -- consumers ------------------------------------------------------
    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def alpha_scale(self) -> float:
        """The α damping in effect (1.0 when not degraded)."""
        with self._lock:
            return self.config.degraded_alpha_scale if self._degraded else 1.0

    def pop_events(self) -> List[dict]:
        """Drain the accumulated membership events."""
        with self._lock:
            events, self._events = self._events, []
            return events

    def pop_heal_advice(self) -> Optional[dict]:
        """The pending heal-reconciliation advice, if any (one-shot)."""
        with self._lock:
            advice, self._heal_advice = self._heal_advice, None
            return advice

    def view_snapshot(self) -> dict:
        """JSON-ready membership view for health records.  Called by
        ``Scoreboard.snapshot`` with the scoreboard lock held: reports the
        gossip view, not the local overlay."""
        with self._lock:
            snap = {
                "incarnation": self.incarnation,
                "component_id": min(self._component),
                "component": sorted(self._component),
                "component_size": len(self._component),
                "partition_state": "degraded" if self._degraded else "ok",
                "incarnations": {p: e.incarnation for p, e in sorted(self._view.items())},
            }
            if self._evicted:
                snap["evicted"] = sorted(self._evicted)
            return snap
