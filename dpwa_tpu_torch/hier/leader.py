"""Per-island leader election and failover succession (the port of
:mod:`dpwa_tpu.hier.leader`).

Each island elects one leader, the only member that speaks across
islands.  The election is :func:`~dpwa_tpu_torch.parallel.schedules.
leader_draw` keyed on ``(seed, term, island)`` over the island's sorted
live members, so every node that agrees on who is alive elects the same
leader with no message.  A dead leader bumps its island's term and the
draw is made again over the survivors.  Terms only increase and ride the
v2 membership digest, so a stale claim loses to its successor's.

The board's events are bare dicts (``leader_elected`` /
``leader_failover``), key for key the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from dpwa_tpu_torch.hier.topology import Topology
from dpwa_tpu_torch.parallel.schedules import leader_draw


class LeaderBoard:
    """Who speaks for each island, at which term.  Not thread-safe: the
    plane that owns it (the membership manager, under its lock) serialises
    the calls."""

    def __init__(self, topology: Topology, seed: int = 0):
        self.topology = topology
        self.seed = int(seed)
        self._terms: List[int] = [0] * topology.n_islands
        self._alive: List[set] = [set(topology.members_of(g)) for g in range(topology.n_islands)]
        self._leaders: List[Optional[int]] = [self._elect(g) for g in range(topology.n_islands)]

    def _elect(self, island: int) -> Optional[int]:
        """The leader of ``island`` at its current term over the sorted
        survivors; None when none is left."""
        candidates = sorted(self._alive[island])
        if not candidates:
            return None
        return candidates[leader_draw(self.seed, self._terms[island], island, len(candidates))]

    def _event(self, kind: str, island: int, **extra) -> dict:
        return {"event": kind, "island": self.topology.island_name(island), **extra}

    # -- queries ---------------------------------------------------------
    def leader_of(self, island: int) -> Optional[int]:
        return self._leaders[island]

    def term_of(self, island: int) -> int:
        return self._terms[island]

    def is_leader(self, peer: int) -> bool:
        return self._leaders[self.topology.island_of(peer)] == peer

    def leaders(self) -> Dict[int, Optional[int]]:
        """Island index -> its leader (None: the island is empty)."""
        return dict(enumerate(self._leaders))

    # -- lifecycle -------------------------------------------------------
    def initial_events(self) -> List[dict]:
        """The term-0 ``leader_elected`` events, one a non-empty island."""
        return [self._event("leader_elected", g, peer=leader, term=self._terms[g])
                for g, leader in enumerate(self._leaders) if leader is not None]

    def note_dead(self, peer: int) -> List[dict]:
        """Fold a death in.  A dead non-leader only shrinks the candidates
        of later elections; a dead leader bumps the term and draws its
        successor: one ``leader_failover`` event."""
        g = self.topology.island_of(peer)
        self._alive[g].discard(peer)
        if self._leaders[g] != peer:
            return []
        self._terms[g] += 1
        self._leaders[g] = self._elect(g)
        return [self._event("leader_failover", g, old_leader=peer, peer=self._leaders[g],
                            term=self._terms[g])]

    def adopt(self, island: int, term: int, leader: Optional[int]) -> List[dict]:
        """Fold a remote leadership claim (a v2 digest entry).  A claim at a
        higher term is fresher and is adopted outright; same-term claims
        agree by construction and lower terms are stale, so both change
        nothing.  Returns the ``leader_elected`` event it caused, if any."""
        term = int(term)
        if term <= self._terms[island]:
            return []
        self._terms[island] = term
        self._leaders[island] = leader if leader is not None else self._elect(island)
        if self._leaders[island] is None:
            return []
        return [self._event("leader_elected", island, peer=self._leaders[island], term=term)]

    def note_alive(self, peer: int) -> List[dict]:
        """``peer`` rejoined its island's candidates.  Leadership is sticky
        (a return elects no one) unless the island had no leader left: then
        the returnee's arrival elects one at a fresh term."""
        g = self.topology.island_of(peer)
        self._alive[g].add(peer)
        if self._leaders[g] is not None:
            return []
        self._terms[g] += 1
        self._leaders[g] = self._elect(g)
        return [self._event("leader_elected", g, peer=self._leaders[g], term=self._terms[g])]
