"""Hierarchical gossip: islands under a wide-area ring (the port of
:mod:`dpwa_tpu.hier`).

The ``topology:`` block partitions ``nodes:`` into islands; each island
averages internally and speaks across islands through one threefry-elected
leader.  The package holds the resolved topology, the leader board
(election and failover succession), the two-level TCP pairing schedule and
the in-process simulator, its replicas on a device.
"""

from dpwa_tpu_torch.hier.engine import HierGossipEngine
from dpwa_tpu_torch.hier.leader import LeaderBoard
from dpwa_tpu_torch.hier.schedule import build_hier_schedule, wide_slot_indices
from dpwa_tpu_torch.hier.topology import Topology

__all__ = [
    "HierGossipEngine",
    "LeaderBoard",
    "Topology",
    "build_hier_schedule",
    "wide_slot_indices",
]
