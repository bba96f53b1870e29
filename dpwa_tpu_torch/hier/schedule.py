"""Two-level (island × wide-area) pairing schedule for the TCP ring (the
port of :mod:`dpwa_tpu.hier.schedule`).

A standard :class:`~dpwa_tpu_torch.parallel.schedules.Schedule` whose pool
holds the hierarchical cycle:

- **intra slots**: each island ring-pairs its members (the even and the odd
  phase), ``topology.intra_rounds`` sweeps a block;
- **inter slots**: only the term-0 island leaders pair, on a round-robin
  tournament over islands; every other peer self-pairs, and a self-pair
  does not fetch (``Schedule.participates`` is False), which is where the
  wide-area frames fall by about the island size.

The pool is static.  A dead leader is quarantined by the scoreboard and
``Schedule.remap_partner`` draws the fetch again, while the membership
plane's :class:`LeaderBoard` converges on the successor.
"""

from __future__ import annotations

import numpy as np

from dpwa_tpu_torch.config import DpwaConfig
from dpwa_tpu_torch.hier.leader import LeaderBoard
from dpwa_tpu_torch.hier.topology import Topology
from dpwa_tpu_torch.parallel.schedules import (
    Schedule,
    _group_round_robin,
    _ring_even,
    _ring_odd,
    is_involution,
)


def _intra_perm(topo: Topology, phase: int) -> np.ndarray:
    """One intra-island slot: each island's members ring-paired among
    themselves (phase 0 the even pairs, 1 the odd), a lone member
    self-paired."""
    perm = np.arange(topo.n_peers)
    ring = _ring_even if phase % 2 == 0 else _ring_odd
    for g in range(topo.n_islands):
        members = np.asarray(topo.members_of(g))
        if len(members) >= 2:
            perm[members] = members[ring(len(members))]
    return perm


def _inter_perm(topo: Topology, board: LeaderBoard, gperm: np.ndarray) -> np.ndarray:
    """One wide-area slot: the tournament round's island pairing applied to
    the island leaders; everyone else self-pairs."""
    perm = np.arange(topo.n_peers)
    for g in range(topo.n_islands):
        pg = int(gperm[g])
        if pg == g:
            continue
        a, b = board.leader_of(g), board.leader_of(pg)
        if a is not None and b is not None:
            perm[a], perm[b] = b, a
    return perm


def build_hier_schedule(config: DpwaConfig) -> Schedule:
    """The hierarchical pool of ``config.topology``."""
    topo = Topology.from_config(config)
    board = LeaderBoard(topo, seed=config.topology.leader_seed)
    proto = config.protocol
    pool = [_intra_perm(topo, 0), _intra_perm(topo, 1)]
    intra_cycle = [0, 1] * config.topology.intra_rounds
    cycle: list = []
    if topo.n_islands > 1:
        for gperm in _group_round_robin(topo.n_islands):
            cycle.extend(intra_cycle)
            pool.append(_inter_perm(topo, board, gperm))
            cycle.append(len(pool) - 1)
    else:
        cycle.extend(intra_cycle)
    arr = np.stack(pool).astype(np.int32)
    for row in arr:
        assert is_involution(row), "hier slot is not an involution"
    return Schedule(
        pool=arr,
        n_peers=config.n_peers,
        fetch_probability=proto.fetch_probability,
        seed=proto.seed,
        name="hier",
        drop_probability=proto.drop_probability,
        mode="pairwise",
        wire_dtype=proto.wire_dtype,
        branch_map=np.asarray(cycle, dtype=np.int32),
    )


def wide_slot_indices(schedule: Schedule, topo: Topology) -> tuple:
    """The pool rows whose pairings cross islands (the wide-area slots)."""
    return tuple(
        k for k, row in enumerate(schedule.pool)
        if any(topo.island_of(i) != topo.island_of(int(row[i])) for i in range(len(row)))
    )
