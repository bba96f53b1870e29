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

With ``membership.view`` on, the manager also owns the bounded partial
view (:class:`~dpwa_tpu_torch.membership.partial_view.PartialView`): each
digest carries a drawn sample of the tracked peers, the per-peer state of
the planes is LRU-capped at ``state_cap`` (cap evictions go through the
same evict listeners as dead ones, cause-tagged apart, and never count
against quorum), quorum runs over the tracked horizon, and a dead active
peer's slot is refilled from the passive view.

Under the hierarchical topology (a ``topology:`` block) the digest is
encoded at version 2, each entry stamped with its peer's island, the
island's leadership term and a leader flag, and :meth:`MembershipManager.
merge` folds remote leader claims into the node's
:class:`~dpwa_tpu_torch.hier.leader.LeaderBoard`; a flat ring stays on
version 1, byte for byte.

Every decision counts gossip rounds; there is no wall clock, so equal
outcome sequences give equal event streams, in either package.
:func:`register_metrics` exposes the view on ``/metrics``.

Thread safety: state changes take the internal lock.  Scoreboard calls are
made outside it (the scoreboard's snapshot calls back into
:meth:`view_snapshot`; holding both locks in opposite orders would
deadlock).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Set

from dpwa_tpu_torch.config import MembershipConfig
from dpwa_tpu_torch.health.scoreboard import PeerState, Scoreboard
from dpwa_tpu_torch.membership.digest import (
    ALIVE,
    DEAD,
    DIGEST_VERSION,
    DIGEST_VERSION_HIER,
    NO_ISLAND,
    QUARANTINED,
    STATE_NAMES,
    SUSPECT,
    Digest,
    MemberEntry,
    decode_digest,
    encode_digest,
    merge_entry,
)
from dpwa_tpu_torch.membership.partial_view import PartialView

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
        topology: Optional[Any] = None,
        leader_board: Optional[Any] = None,
    ):
        self.config = config if config is not None else MembershipConfig()
        self.n_peers = n_peers
        self.me = me
        self.seed = seed
        self.scoreboard = scoreboard
        # The hier Topology (None on a flat ring): v2 digests, and remote
        # leader claims folded into the board.
        self.topology = topology
        if topology is not None and leader_board is None:
            from dpwa_tpu_torch.hier.leader import LeaderBoard

            leader_board = LeaderBoard(topology, seed=seed)
        self.leader_board = leader_board
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
        # The bounded partial view (config.view).  Cap-evicted peers land in
        # _capped: tombstoned and pruned like dead ones, but untracked, not
        # dead, so they stay out of the quorum's arithmetic.
        self.partial: Optional[PartialView] = (
            PartialView(n_peers, me, self.config.view, seed=seed, topology=topology,
                        leader_board=leader_board)
            if self.config.view.enabled else None
        )
        self._capped: Set[int] = set()
        self._evictions_by_cause = {"dead": 0, "cap": 0}
        self._digest_entries_last = 0
        # High-water marks over end_round under the view: a cap enforced
        # only at round end could hide a spike from a final-size check.
        self._peak_resident = 0
        self._peak_sb_tracked = 0
        # Predicates consulted (outside the lock) before a cap eviction:
        # the transport registers trust's collapsed check.
        self._cap_protectors: List[Callable[[int], bool]] = []
        scoreboard.attach_membership(self)

    def add_evict_listener(self, fn: Callable[[int], None]) -> None:
        """Register a callback fired once per peer eviction."""
        with self._lock:
            self._evict_listeners.append(fn)

    def add_cap_protector(self, fn: Callable[[int], bool]) -> None:
        """Register a predicate that shields peers from a cap eviction
        (trust's collapsed check); dead evictions do not consult it."""
        with self._lock:
            self._cap_protectors.append(fn)

    def partner_candidates(self) -> Optional[List[int]]:
        """The sorted active view with the partial view on, else None
        (draws range over all of ``nodes:``)."""
        part = self.partial
        if part is None:
            return None
        with self._lock:
            return sorted(part.active)

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

    def _combined_all(self, tracked: Optional[List[int]] = None) -> Dict[int, MemberEntry]:
        """The combined entry of every peer but the evicted ones, or of
        ``tracked`` (scoreboard reads: call without the lock)."""
        if tracked is not None:
            return {p: self._combined(p) for p in tracked}
        with self._lock:
            evicted = set(self._evicted)
        return {
            p: self._combined(p)
            for p in range(self.n_peers)
            if p != self.me and p not in evicted
        }

    def _tracked_candidates(self) -> List[int]:
        """The sorted tracked horizon under the partial view (lock held):
        every peer the gossip view or the active view names, less the
        tombstones.  O(state_cap + active), never O(N)."""
        tracked = set(self._view) | self.partial.active
        tracked -= self._evicted
        tracked -= self._capped
        tracked.discard(self.me)
        return sorted(tracked)

    # -- digest I/O (the transport's publish and fetch paths) -----------
    def encode(self, round: int) -> bytes:
        """The digest this round's published frame carries: every peer but
        the evicted ones, and this node ALIVE at its incarnation.  Under
        the partial view the candidates are the tracked horizon and the
        digest carries :meth:`PartialView.sample_digest`'s sample of them
        (damning entries first); a sample that covers them all is the
        whole list, the global view's frame."""
        with self._lock:
            part = self.partial
            tracked = self._tracked_candidates() if part is not None else None
        combined = self._combined_all(tracked)
        with self._lock:
            self._round = max(self._round, int(round))
            if part is not None:
                damning = {p for p, e in combined.items() if e.state >= QUARANTINED}
                entries = {p: combined[p]
                           for p in part.sample_digest(sorted(combined), damning, int(round))}
            else:
                entries = combined
            self._digest_entries_last = len(entries) + 1
            entries[self.me] = MemberEntry(state=ALIVE, incarnation=self.incarnation, suspicion=0.0)
            version = DIGEST_VERSION
            if self.topology is not None:
                # Each entry carries its island and the island's current
                # claim (term and leader flag), read under the lock merge()
                # changes the board under.
                version = DIGEST_VERSION_HIER
                topo, board = self.topology, self.leader_board
                for peer, e in sorted(entries.items()):
                    g = topo.island_of(peer)
                    entries[peer] = dataclasses.replace(
                        e, island=g, leader_term=board.term_of(g),
                        is_leader=board.leader_of(g) == peer)
            return encode_digest(Digest(origin=self.me, round=int(round), entries=entries,
                                        version=version))

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
        uncapped: List[int] = []
        events: List[dict] = []
        with self._lock:
            self._round = max(self._round, r)
            part = self.partial
            if part is not None and digest.origin != self.me:
                part.touch(digest.origin, r)
            for peer, claim in sorted(digest.entries.items()):
                if peer >= self.n_peers:
                    continue
                if part is not None and peer != self.me:
                    # Recency for the cap, and discovery: an unknown peer a
                    # digest names enters the views.
                    part.touch(peer, r)
                    if peer in self._capped:
                        # A mention re-tracks a capped peer (untracked, not
                        # dead); an alive-ish claim also clears its
                        # scoreboard tombstone, below.
                        self._capped.discard(peer)
                        if claim.state <= SUSPECT:
                            uncapped.append(peer)
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
            if self.leader_board is not None and digest.version == DIGEST_VERSION_HIER:
                # A leader-flagged claim at a higher term moves the board to
                # the successor (LeaderBoard.adopt drops stale and same-term
                # claims).
                topo = self.topology
                for peer, claim in sorted(digest.entries.items()):
                    if (not claim.is_leader or claim.island == NO_ISLAND
                            or claim.island >= topo.n_islands or peer >= self.n_peers
                            or topo.island_of(peer) != claim.island):
                        continue
                    events.extend(self.leader_board.adopt(claim.island, claim.leader_term, peer))
            self._events.extend(events)
        for peer in uncapped:
            # Clears the cap tombstone: a clean record, rebuilt from the
            # claims just folded.
            self.scoreboard.readmit(peer, round=r)
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
                    self._capped.discard(peer)
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
        ring came back.  Under the partial view this is also where the
        ``state_cap`` is enforced: residency across the membership and
        scoreboard maps is measured, and the least recently touched peers
        outside the active view and the protected ones (quarantined, or
        shielded by a protector) are cap-evicted through the evict
        listeners; a dead active peer's slot is refilled from the passive
        view, and the passive view shuffles on its cadence."""
        with self._lock:
            part = self.partial
            tracked = self._tracked_candidates() if part is not None else None
            evicted = set(self._evicted)
            view_keys = set(self._view) if part is not None else set()
            touch_keys = set(part._last_touch) if part is not None else set()
            protectors = list(self._cap_protectors) if part is not None else []
        combined = self._combined_all(tracked)
        # The cap's inputs, read outside our lock too: the scoreboard's
        # resident peers, its quarantine verdicts and the protectors.
        protected: Set[int] = set()
        sb_tracked: List[int] = []
        if part is not None:
            sb_tracked = self.scoreboard.tracked_peers()
            for p in sorted(view_keys | set(sb_tracked) | touch_keys):
                if p == self.me or p in evicted:
                    continue
                if self.scoreboard.state(p) == PeerState.QUARANTINED or any(
                        fn(p) for fn in protectors):
                    protected.add(p)
        component = {self.me} | {p for p, e in combined.items() if e.state <= SUSPECT}
        dead_now = {p for p, e in combined.items() if e.state >= DEAD}
        step = int(step)
        events: List[dict] = []
        evictions: List[int] = []
        cap_evictions: List[int] = []
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
            # Quorum and heal fractions run over the ring that still exists:
            # under the partial view, this node's tracked horizon (itself
            # and the tracked peers, less this round's dead evictions), equal
            # to the global formula with a full view.
            if part is None:
                alive_universe = max(1, self.n_peers - len(self._evicted))
            else:
                alive_universe = max(1, 1 + len(tracked) - len(evictions))
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
            if part is not None:
                cap_evictions = self._enforce_cap(part, step, evictions, sb_tracked, protected,
                                                  events)
            self._events.extend(events)
            listeners = list(self._evict_listeners)
        # Prune the other planes outside our lock (theirs-before-ours).
        for p in evictions + cap_evictions:
            self.scoreboard.evict_peer(p, round=step)
            for fn in listeners:
                fn(p)

    def _enforce_cap(self, part: PartialView, step: int, evictions: List[int],
                     sb_tracked: List[int], protected: Set[int], events: List[dict]) -> List[int]:
        """The partial view's round end (lock held): a dead active peer is
        forgotten (promoting a passive one), the passive view shuffles, and
        the resident peers over ``state_cap`` are cap-evicted, least
        recently touched first; the victims, tombstoned here and pruned by
        the caller."""
        self._evictions_by_cause["dead"] += len(evictions)
        for p in evictions:
            part.forget(p)
        part.maybe_shuffle(step)
        cap = self.config.view.state_cap
        resident = (set(self._view) | set(sb_tracked) | set(part._last_touch)) - (
            self._evicted | self._capped | {self.me})
        resident -= set(evictions)
        victims = part.cap_victims(resident, protected, len(resident) - cap)
        for p in victims:
            self._view.pop(p, None)
            part.forget(p)
            self._capped.add(p)
        self._peak_resident = max(self._peak_resident, len(resident) - len(victims))
        self._peak_sb_tracked = max(self._peak_sb_tracked, len(sb_tracked))
        if victims:
            self._evictions_by_cause["cap"] += len(victims)
            events.append({"event": "peers_capped", "peers": victims, "state_cap": cap})
        return victims

    def on_peer_returned(self, peer: int, round: Optional[int] = None) -> None:
        """Direct probe evidence that an evicted peer is back.  Called by
        ``Scoreboard.record_probe`` with the scoreboard lock held: must not
        call back into the scoreboard.  Clears the eviction and downgrades
        the stale DEAD entry to ALIVE at the same incarnation.  A capped
        peer (untracked, not dead) is tracked again, with no rejoin event."""
        r = int(round) if round is not None else None
        with self._lock:
            if peer in self._capped:
                self._capped.discard(peer)
                if self.partial is not None:
                    self.partial.touch(peer, r if r is not None else self._round)
                return
            if peer not in self._evicted:
                return
            self._evicted.discard(peer)
            self._dead_since.pop(peer, None)
            if self.partial is not None:
                self.partial.touch(peer, r if r is not None else self._round)
            entry = self._view.get(peer)
            if entry is not None and entry.state > ALIVE:
                self._view[peer] = MemberEntry(
                    state=ALIVE, incarnation=entry.incarnation, suspicion=0.0
                )
            self._events.append({
                "event": "peer_rejoined",
                "peer": peer,
                "via": "probe",
                "round": r,
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
            if self.partial is not None:
                # Present exactly when the partial view is on.
                part = self.partial.snapshot()
                snap["view"] = {
                    "view_active": part["active_size"],
                    "view_passive": part["passive_size"],
                    "view_tracked": len(self._tracked_candidates()),
                    "view_capped": len(self._capped),
                    "view_digest_entries": self._digest_entries_last,
                    "view_evicted_dead": self._evictions_by_cause["dead"],
                    "view_evicted_cap": self._evictions_by_cause["cap"],
                    "view_promotions": part["promotions"],
                    "view_shuffles": part["shuffles"],
                }
            return snap


def register_metrics(registry, manager: MembershipManager) -> None:
    """The membership plane on a ``/metrics`` registry."""
    from dpwa_tpu_torch.obs.prometheus import Family

    def collect():
        view = manager.view_snapshot()
        return [
            Family("dpwa_membership_incarnation", "counter",
                   "Own SWIM incarnation number").sample(view.get("incarnation")),
            Family("dpwa_membership_component_size", "gauge",
                   "Size of the connected component this node sits in").sample(
                view.get("component_size")),
            Family("dpwa_membership_degraded", "gauge",
                   "1 when the partition quorum check has degraded the node").sample(
                view.get("partition_state") == "degraded"),
        ]

    registry.register(collect)
