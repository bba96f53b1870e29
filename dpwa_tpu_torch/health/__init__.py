"""Peer health on the TCP transport: the failure detector and the
scoreboard's quarantine, probe and remap (the port of
:mod:`dpwa_tpu.health`).  The chaos harness (:mod:`~dpwa_tpu_torch.health.
chaos`) and the ``/healthz`` endpoint (:mod:`~dpwa_tpu_torch.health.
endpoint`) are imported from their modules: the harness imports the
transport, which imports this package."""

from dpwa_tpu_torch.health.detector import (  # noqa: F401
    DEFAULT_FAILURE_WEIGHTS,
    FailureDetector,
    Outcome,
    PeerRecord,
)
from dpwa_tpu_torch.health.scoreboard import (  # noqa: F401
    PeerState,
    Scoreboard,
    run_probe,
)

__all__ = [
    "DEFAULT_FAILURE_WEIGHTS",
    "FailureDetector",
    "Outcome",
    "PeerRecord",
    "PeerState",
    "Scoreboard",
    "run_probe",
]
