"""Per-process adapters over the TCP transport (:mod:`.tcp_adapter`)."""

from dpwa_tpu_torch.adapters.tcp_adapter import (  # noqa: F401
    DpwaPyTorchAdapter,
    DpwaTcpAdapter,
    DpwaTorchAdapter,
)
