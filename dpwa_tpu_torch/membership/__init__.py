"""Epidemic membership, partition tolerance and heal-time reconciliation on
the TCP transport (the port of :mod:`dpwa_tpu.membership`):

- :mod:`~dpwa_tpu_torch.membership.digest`: the compact versioned digest
  every frame carries as an optional trailer, and the incarnation-based
  merge rules;
- :mod:`~dpwa_tpu_torch.membership.manager`: the merged view, refutation,
  component, quorum and degraded mode, eviction, and the heal advice the
  adapter acts on;
- :mod:`~dpwa_tpu_torch.membership.partial_view`: the bounded partial
  view (``membership.view``): the active and passive views, the digest
  sample and the LRU cap's victims, seeded island-first under the
  hierarchical topology.

The transport's wiring (the trailer, the RELAY verb, indirect probes, the
view's candidates) is in :mod:`dpwa_tpu_torch.parallel.tcp`; the heal's
state merge is the adapter's."""

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
from dpwa_tpu_torch.membership.manager import MembershipManager
from dpwa_tpu_torch.membership.partial_view import PartialView

__all__ = [
    "ALIVE",
    "SUSPECT",
    "QUARANTINED",
    "DEAD",
    "STATE_NAMES",
    "Digest",
    "MemberEntry",
    "decode_digest",
    "encode_digest",
    "merge_entry",
    "MembershipManager",
    "PartialView",
]
