"""Content-trust plane on the TCP transport: screen every fetched payload
against the local replica where it lies, damp or reject suspicious merges,
quarantine byzantine peers (the port of :mod:`dpwa_tpu.trust`)."""

from dpwa_tpu_torch.trust.manager import (
    REJECTED,
    SUSPECT,
    TRUSTED,
    TrustManager,
)
from dpwa_tpu_torch.trust.screen import (
    BASE_STATS,
    RobustBaseline,
    leaf_starts_from_sizes,
    payload_stats,
)

__all__ = [
    "BASE_STATS",
    "REJECTED",
    "SUSPECT",
    "TRUSTED",
    "RobustBaseline",
    "TrustManager",
    "leaf_starts_from_sizes",
    "payload_stats",
]
