"""Island topology: the resolved two-level view of the ``nodes:`` list (the
port of :mod:`dpwa_tpu.hier.topology`).

``config.topology`` names islands by node name; the schedule, the digests
and the leader board work in peer ids (positions in ``nodes:``).
:class:`Topology` is that resolution, computed once and frozen: a partition
of ``range(n_peers)`` into named islands with lookups both ways.  A flat
config has none; callers gate on ``config.topology.enabled``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from dpwa_tpu_torch.config import DpwaConfig


@dataclasses.dataclass(frozen=True)
class Topology:
    """A validated partition of peer ids into islands.

    Attributes:
      names: island names, in declaration order.
      members: per island, its peer ids sorted ascending.
      n_peers: the ring's size (the partition is total).
    """

    names: Tuple[str, ...]
    members: Tuple[Tuple[int, ...], ...]
    n_peers: int

    @classmethod
    def from_config(cls, config: DpwaConfig) -> "Topology":
        """``config.topology`` resolved against ``config.nodes`` (the config
        has already checked the partition)."""
        if not config.topology.enabled:
            raise ValueError(
                "Topology.from_config on a flat config — gate on"
                " config.topology.enabled first"
            )
        index = {name: i for i, name in enumerate(config.node_names)}
        return cls(
            names=tuple(isl.name for isl in config.topology.islands),
            members=tuple(tuple(sorted(index[n] for n in isl.nodes))
                          for isl in config.topology.islands),
            n_peers=config.n_peers,
        )

    @classmethod
    def uniform(cls, n_islands: int, island_size: int) -> "Topology":
        """An even partition: island ``g`` owns peers ``[g*island_size,
        (g+1)*island_size)``."""
        if n_islands < 1 or island_size < 1:
            raise ValueError(
                f"need n_islands >= 1 and island_size >= 1, got"
                f" {n_islands} x {island_size}"
            )
        return cls(
            names=tuple(f"island{g}" for g in range(n_islands)),
            members=tuple(tuple(range(g * island_size, (g + 1) * island_size))
                          for g in range(n_islands)),
            n_peers=n_islands * island_size,
        )

    def __post_init__(self) -> None:
        seen: set = set()
        for ms in self.members:
            for p in ms:
                if p in seen:
                    raise ValueError(f"peer {p} in two islands")
                seen.add(p)
        if seen != set(range(self.n_peers)):
            raise ValueError(
                f"islands cover {sorted(seen)}, expected all of range({self.n_peers})"
            )
        island_of = [0] * self.n_peers
        for g, ms in enumerate(self.members):
            for p in ms:
                island_of[p] = g
        object.__setattr__(self, "_island_of", tuple(island_of))

    @property
    def n_islands(self) -> int:
        return len(self.members)

    def island_of(self, peer: int) -> int:
        """Index of the island that owns ``peer``."""
        return self._island_of[peer]  # type: ignore[attr-defined]

    def members_of(self, island: int) -> Tuple[int, ...]:
        """Sorted peer ids of ``island``."""
        return self.members[island]

    def island_name(self, island: int) -> str:
        return self.names[island]
