"""Bounded partial views: a node's horizon over a large ring (the port of
:mod:`dpwa_tpu.membership.partial_view`).

A HyParView-style split view:

- the **active view** is the small set of peers this node gossips with and
  probes: partner remaps, hedge fallbacks and indirect-probe relays draw
  from it instead of from all of ``nodes:``;
- the **passive view** is a reservoir of known candidates: when an active
  peer is evicted, a replacement is promoted from it by a threefry draw,
  and a slow shuffle keeps it stocked with recently heard-of peers.

Two bounds on top make every control plane O(sample) instead of O(N):
each published digest carries a drawn sample of ``digest_sample`` tracked
peers (:meth:`PartialView.sample_digest`, damning claims first), and the
per-peer maps of the planes are LRU-capped at ``state_cap``
(:meth:`PartialView.cap_victims` orders the victims; the membership
manager enforces the cap).

With ``digest_sample >= N``, ``state_cap >= N`` and ``active_size >= N -
1`` every candidate list, draw, frame and decision is the global view's:
sampling only truncates canonical orders.  Everything is keyed on gossip
rounds and threefry draws, never wall time.  Instances belong to a
:class:`~dpwa_tpu_torch.membership.manager.MembershipManager`, which calls
them under its lock; there is no lock here.

The views are seeded from a deterministic order of the ring: on the flat
ring the successors ``me+1, me+2, …``; under the hierarchical topology the
node's own island first, then the other islands' leaders, then the ring
successors not yet named.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Set

from dpwa_tpu_torch.config import ViewConfig
from dpwa_tpu_torch.parallel.schedules import passive_shuffle_draw, view_sample_draw


class PartialView:
    """Active and passive partial views and the digest-sample rule."""

    def __init__(self, n_peers: int, me: int, config: Optional[ViewConfig] = None,
                 seed: int = 0, topology: Optional[Any] = None,
                 leader_board: Optional[Any] = None):
        self.config = config if config is not None else ViewConfig()
        self.n_peers = int(n_peers)
        self.me = int(me)
        self.seed = seed
        self.topology = topology
        self.leader_board = leader_board
        # Sets, sorted when read (the views hold active_size / passive_size
        # entries).
        self.active: Set[int] = set()
        self.passive: Set[int] = set()
        # peer -> the last round it was heard of (a digest entry or origin,
        # or direct contact); pruned by forget().
        self._last_touch: Dict[int, int] = {}
        self.promotions = 0
        self.shuffles = 0
        ordered = self._initial_candidates()
        a = self.config.active_size
        self.active = set(ordered[:a])
        self.passive = set(ordered[a:a + self.config.passive_size])

    def _initial_candidates(self) -> List[int]:
        """The bootstrap order of the ring: the successors of ``me`` on a
        flat ring; under a topology the island's other members, then the
        other leaders, then the successors not yet named."""
        successors = [(self.me + i) % self.n_peers for i in range(1, self.n_peers)]
        if self.topology is None:
            return successors
        ordered = [p for p in self.topology.members_of(self.topology.island_of(self.me))
                   if p != self.me]
        if self.leader_board is not None:
            for island in range(self.topology.n_islands):
                leader = self.leader_board.leader_of(island)
                if leader is not None and leader != self.me and leader not in ordered:
                    ordered.append(leader)
        seen = set(ordered)
        return ordered + [p for p in successors if p not in seen]

    # -- recency (the LRU cap's order) ----------------------------------
    def touch(self, peer: int, round_: int) -> None:
        """``peer`` was heard of at ``round_``.  An unknown peer refills an
        undersized active view directly (a rejoiner takes the slot its
        death vacated, which keeps the ``active_size >= N - 1`` identity
        across churn), else enters the passive reservoir while there is
        room."""
        if peer == self.me or not 0 <= peer < self.n_peers:
            return
        prev = self._last_touch.get(peer)
        if prev is None or round_ > prev:
            self._last_touch[peer] = int(round_)
        if peer in self.active or peer in self.passive:
            return
        if len(self.active) < self.config.active_size:
            self.active.add(peer)
        elif len(self.passive) < self.config.passive_size:
            self.passive.add(peer)

    def last_touch(self, peer: int) -> int:
        return self._last_touch.get(peer, -1)

    def forget(self, peer: int) -> None:
        """Drop every trace of ``peer`` (a dead or a cap eviction); the
        active slot it held is refilled from the passive reservoir."""
        self._last_touch.pop(peer, None)
        self.passive.discard(peer)
        if peer in self.active:
            self.active.discard(peer)
            self._promote(peer)

    # -- view maintenance -----------------------------------------------
    def _promote(self, failed_peer: int) -> None:
        """Refill the active view after ``failed_peer`` left it: a
        :func:`passive_shuffle_draw` over the sorted reservoir, keyed on the
        failed peer (two failures of one round draw independently)."""
        candidates = sorted(self.passive)
        if not candidates:
            return
        pick = candidates[passive_shuffle_draw(self.seed, failed_peer, self.me, len(candidates))]
        self.passive.discard(pick)
        self.active.add(pick)
        self.promotions += 1

    def maybe_shuffle(self, round_: int) -> None:
        """Every ``shuffle_every`` rounds, put the most recently heard-of
        peer outside both views (ties to the lower id) into the passive
        reservoir, displacing a drawn resident when it is full."""
        every = self.config.shuffle_every
        if every <= 0 or round_ <= 0 or round_ % every != 0:
            return
        fresh: Optional[int] = None
        fresh_round = -1
        for p, r in sorted(self._last_touch.items()):
            if p in self.active or p in self.passive:
                continue
            if r > fresh_round or (r == fresh_round and (fresh is None or p < fresh)):
                fresh, fresh_round = p, r
        if fresh is None:
            return
        if len(self.passive) >= max(1, self.config.passive_size):
            residents = sorted(self.passive)
            self.passive.discard(
                residents[passive_shuffle_draw(self.seed, round_, self.me, len(residents))])
        self.passive.add(fresh)
        self.shuffles += 1

    # -- digest sampling ------------------------------------------------
    def sample_digest(self, candidates: Sequence[int], damning: Iterable[int],
                      clock: int) -> List[int]:
        """The sorted subset of ``candidates`` this frame's digest carries:
        all of them when ``digest_sample`` covers them; else the damning
        peers (quarantined or worse) first, in id order, then the
        :func:`view_sample_draw` permutation of the list at ``clock``."""
        k = self.config.digest_sample
        ordered = sorted(candidates)
        if len(ordered) <= k:
            return ordered
        damning = set(damning)
        chosen: List[int] = [p for p in ordered if p in damning][:k]
        if len(chosen) < k:
            picked = set(chosen)
            for idx in view_sample_draw(self.seed, clock, self.me, len(ordered)):
                p = ordered[int(idx)]
                if p not in picked:
                    chosen.append(p)
                    picked.add(p)
                    if len(chosen) >= k:
                        break
        return sorted(chosen)

    # -- victims of the LRU cap -----------------------------------------
    def cap_victims(self, resident: Iterable[int], protected: Iterable[int],
                    excess: int) -> List[int]:
        """The ``excess`` least recently touched resident peers outside the
        active view, ``protected`` and this node; ties by peer id."""
        if excess <= 0:
            return []
        protected = set(protected) | self.active | {self.me}
        eligible = sorted((p for p in resident if p not in protected),
                          key=lambda p: (self._last_touch.get(p, -1), p))
        return eligible[:excess]

    def snapshot(self) -> dict:
        """JSON-ready view state (folded into the manager's ``view``)."""
        return {
            "active_size": len(self.active),
            "passive_size": len(self.passive),
            "active": sorted(self.active),
            "promotions": self.promotions,
            "shuffles": self.shuffles,
        }
