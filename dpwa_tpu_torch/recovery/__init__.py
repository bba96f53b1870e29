"""Recovery on the TCP transport (the port of :mod:`dpwa_tpu.recovery`):
the guard that defines a sane replica and the rollback ring kept on the
replica's device (:mod:`.guard`), the STATE blob (:mod:`.state_transfer`),
and the bootstrap of a restarted worker from a peer (:mod:`.bootstrap`).

``bootstrap`` imports the TCP transport, which imports ``guard`` from here,
so it loads on first attribute access, as in the reference.
"""

from dpwa_tpu_torch.recovery.guard import (  # noqa: F401
    RollbackRing,
    Snapshot,
    validate_payload,
)
from dpwa_tpu_torch.recovery.state_transfer import (  # noqa: F401
    pack_state,
    unpack_state,
)

__all__ = [
    "RollbackRing",
    "Snapshot",
    "validate_payload",
    "pack_state",
    "unpack_state",
    # lazy (see __getattr__):
    "BootstrapResult",
    "bootstrap_from_peer",
    "choose_donor",
]


def __getattr__(name):
    if name in ("BootstrapResult", "bootstrap_from_peer", "choose_donor"):
        from dpwa_tpu_torch.recovery import bootstrap

        return getattr(bootstrap, name)
    raise AttributeError(f"module 'dpwa_tpu_torch.recovery' has no attribute {name!r}")
