"""In-process hierarchical gossip simulator (the port of
:mod:`dpwa_tpu.hier.engine`), its replicas one ``[n_peers, dim]`` float64
tensor on a device.

The replicas are driven by the real control objects, the
:class:`LeaderBoard` elections and successions and the
:class:`IncidentPlane` observer, with the wire reduced to array averages.
A round (``hier/schedule.py``'s cycle):

1. **intra-island all-reduce**: each island's live members take their
   exact mean, charged ``k·ceil(log2 k)`` intra-island frames;
2. **wide-area leg**: only island leaders exchange, paired by the island
   tournament of the TCP pool; 2 wide-area frames a realised pair;
3. **fan-back**: the leader's merged replica is copied to its island's
   members (intra-island frames again).

``topology=None`` runs the flat even/odd ring, every frame wide-area.  The
arithmetic is the reference's elementwise: ``0.5 * (a + b)``, an island's
rows summed in order and divided by its size (numpy's order for
``mean(axis=0)``), and copies; so the replicas are bit for bit the
reference's, on any device.  The convergence figure ``rel_rms`` is reduced
on the device (float64, within rounding of numpy's).  No wall clock is
read: a rerun at the same seed repeats itself.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from dpwa_tpu_torch.config import ObsConfig
from dpwa_tpu_torch.hier.leader import LeaderBoard
from dpwa_tpu_torch.hier.topology import Topology
from dpwa_tpu_torch.obs.incidents import IncidentPlane
from dpwa_tpu_torch.parallel.schedules import _group_round_robin, _ring_even, _ring_odd
from dpwa_tpu_torch.utils.devices import resolve_device


def _row_mean(rows) -> torch.Tensor:
    """The mean of ``rows`` (a sequence of equal-length rows) in numpy's
    order for ``mean(axis=0)``: summed first to last, then divided by their
    count.  The count is a tensor: CUDA divides by a host scalar as a
    product with its reciprocal, which is not the correctly rounded
    quotient (a count of 3 differs)."""
    acc = rows[0].clone()
    for row in rows[1:]:
        acc += row
    return acc / torch.full_like(acc, len(rows))


def _rel(vecs: torch.Tensor) -> float:
    """RMS of the rows' spread about their mean over the mean's RMS."""
    mean = _row_mean(vecs)
    num = float(torch.sqrt(torch.sub(vecs, mean).square_().mean()))
    den = float(torch.sqrt(torch.mean(mean ** 2))) + 1e-12
    return num / den


class HierGossipEngine:
    """Drive one two-level (or flat) gossip episode over the replicas."""

    def __init__(
        self,
        n_peers: int,
        dim: int = 32,
        seed: int = 0,
        topology: Optional[Topology] = None,
        incidents: Optional[ObsConfig] = None,
        observer: int = 0,
        device=None,
    ):
        if topology is not None and topology.n_peers != n_peers:
            raise ValueError(f"topology covers {topology.n_peers} peers, engine has {n_peers}")
        self.n_peers = int(n_peers)
        self.dim = int(dim)
        self.seed = int(seed)
        self.topology = topology
        self.observer = int(observer)
        self.device = resolve_device(device)
        self.alive = [True] * self.n_peers
        draw = np.random.default_rng(self.seed).standard_normal((self.n_peers, self.dim))
        self.replicas = torch.from_numpy(draw).to(self.device)
        self.board = LeaderBoard(topology, seed=self.seed) if topology is not None else None
        self.incidents = (
            IncidentPlane(self.observer, self.n_peers, incidents, path=None, topology=topology)
            if incidents is not None else None
        )
        self.wide_frames = 0
        self.intra_frames = 0
        self.records: List[dict] = []
        self.events_seen: List[dict] = []
        self.incidents_opened = 0
        self.alerts_total: Dict[str, int] = {}
        # Deaths fold into the board at once; the successions they cause are
        # the next round's evidence, as a digest arrives an exchange later.
        self._pending_events: List[dict] = []
        if self.board is not None:
            self._pending_events.extend(self.board.initial_events())

    # -- lifecycle -------------------------------------------------------
    def kill(self, peer: int) -> None:
        """``peer`` crashed; a leader's death queues its succession."""
        if not self.alive[peer]:
            return
        self.alive[peer] = False
        if self.board is not None:
            self._pending_events.extend(self.board.note_dead(peer))

    def revive(self, peer: int) -> None:
        """``peer`` is back among its island's candidates."""
        if self.alive[peer]:
            return
        self.alive[peer] = True
        if self.board is not None:
            self._pending_events.extend(self.board.note_alive(peer))

    def rel_rms(self) -> float:
        """The live replicas' relative spread (0 with fewer than two)."""
        live = [p for p in range(self.n_peers) if self.alive[p]]
        if len(live) < 2:
            return 0.0
        return _rel(self.replicas if len(live) == self.n_peers else self.replicas[live])

    # -- one round -------------------------------------------------------
    def _merge_pair(self, a: int, b: int) -> None:
        merged = 0.5 * (self.replicas[a] + self.replicas[b])
        self.replicas[a] = merged
        self.replicas[b] = merged
        self.wide_frames += 2  # both sides fetch (pairwise mode)

    def _step_flat(self, r: int) -> None:
        """The flat baseline: one even/odd ring phase, every frame wide."""
        phase = (_ring_even if r % 2 == 0 else _ring_odd)(self.n_peers)
        for i in range(self.n_peers):
            j = int(phase[i])
            if j > i and self.alive[i] and self.alive[j]:
                self._merge_pair(i, j)

    def _intra_allreduce(self, members: List[int]) -> None:
        """The island's exact mean, charged at recursive doubling's cost."""
        k = len(members)
        if k < 2:
            return
        mean = _row_mean([self.replicas[p] for p in members])
        for p in members:
            self.replicas[p].copy_(mean)
        self.intra_frames += k * int(math.ceil(math.log2(k)))

    def _step_hier(self, r: int) -> None:
        topo, board = self.topology, self.board
        live_members = [[p for p in topo.members_of(g) if self.alive[p]]
                        for g in range(topo.n_islands)]
        for members in live_members:
            self._intra_allreduce(members)
        if topo.n_islands > 1:
            rounds = _group_round_robin(topo.n_islands)
            gperm = rounds[r % len(rounds)]
            for g in range(topo.n_islands):
                pg = int(gperm[g])
                if pg <= g:
                    continue
                a, b = board.leader_of(g), board.leader_of(pg)
                if a is not None and b is not None and self.alive[a] and self.alive[b]:
                    self._merge_pair(a, b)
        for g, members in enumerate(live_members):
            leader = board.leader_of(g)
            if leader is None or not self.alive[leader]:
                continue
            followers = [p for p in members if p != leader]
            for p in followers:
                self.replicas[p].copy_(self.replicas[leader])
            self.intra_frames += len(followers)

    def step(self, r: int) -> dict:
        """One gossip round; the observer's result for it."""
        events, self._pending_events = self._pending_events, []
        self.events_seen.extend(events)
        if self.topology is None:
            self._step_flat(r)
        else:
            self._step_hier(r)
        rel = self.rel_rms()
        inc = {"alerts": [], "opened": False}
        if self.incidents is not None:
            inc = self.incidents.observe_round(r, events=events, rel_rms=rel)
            for kind in inc["alerts"]:
                self.alerts_total[kind] = self.alerts_total.get(kind, 0) + 1
            if inc["opened"]:
                self.incidents_opened += 1
        if self.topology is not None:
            for g in range(self.topology.n_islands):
                live = [p for p in self.topology.members_of(g) if self.alive[p]]
                intra_rel = _rel(self.replicas[live]) if len(live) >= 2 else 0.0
                rec = {
                    "record": "island",
                    "round": int(r),
                    "island": self.topology.island_name(g),
                    "term": self.board.term_of(g),
                    "live": len(live),
                    "rel_rms": round(intra_rel, 9),
                    "wide_frames": self.wide_frames,
                }
                leader = self.board.leader_of(g)
                if leader is not None:
                    rec["leader"] = int(leader)
                self.records.append(rec)
        return {"round": r, "rel_rms": rel, **inc}

    def run(self, rounds: int, target_rel: Optional[float] = None) -> dict:
        """Drive ``rounds`` rounds; the episode's summary
        (``rounds_to_target`` None when the target was never reached)."""
        history: List[float] = []
        rounds_to_target: Optional[int] = None
        for r in range(int(rounds)):
            out = self.step(r)
            history.append(out["rel_rms"])
            if target_rel is not None and rounds_to_target is None and out["rel_rms"] <= target_rel:
                rounds_to_target = r + 1
        return {
            "rounds": int(rounds),
            "final_rel_rms": history[-1] if history else 0.0,
            "history": history,
            "rounds_to_target": rounds_to_target,
            "wide_frames": self.wide_frames,
            "intra_frames": self.intra_frames,
            "incidents_opened": self.incidents_opened,
            "alerts": dict(sorted(self.alerts_total.items())),
        }
