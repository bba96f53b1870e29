"""Host ↔ card copies: the one place frame bytes cross between the host
and the card (the port of :mod:`dpwa_tpu.device.handoff`).

:func:`to_device` lands a received payload on the card.  From pinned host
memory (the TCP transport's receive ring on the card) the copy is
asynchronous and returns with an event that says when the host buffer may
be reused; from pageable memory CUDA copies synchronously, so the two are
counted apart.  :func:`to_host` is the readback for publishing: into a new
pinned buffer, which the caller then serves as the published snapshot.  On
the CPU both are plain copies, so a CPU caller gets the same snapshot
semantics.  The byte and copy counters are process-wide, as the
reference's are.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

_LOCK = threading.Lock()
_STATS = {
    "h2d_pinned": 0, "h2d_pageable": 0, "h2d_bytes": 0,
    "d2h_readbacks": 0, "d2h_bytes": 0,
}


def to_device(host: torch.Tensor, device) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """A copy of the CPU tensor ``host`` on ``device``, and for a card the
    event recorded after the copy (None on the CPU, where the copy is done
    when this returns).  Pinned memory copies without blocking the host."""
    device = torch.device(device)
    nbytes = host.numel() * host.element_size()
    if device.type != "cuda":
        out = host.to(device, copy=True)
        event = None
        pinned = False
    else:
        pinned = host.is_pinned()
        out = torch.empty(host.shape, dtype=host.dtype, device=device)
        out.copy_(host, non_blocking=pinned)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    with _LOCK:
        _STATS["h2d_bytes"] += nbytes
        _STATS["h2d_pinned" if pinned else "h2d_pageable"] += 1
    return out, event


def to_host(dev: torch.Tensor) -> torch.Tensor:
    """A snapshot of ``dev`` in host memory (pinned for a card tensor),
    complete when this returns."""
    if dev.device.type == "cuda":
        out = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        out.copy_(dev, non_blocking=True)
        torch.cuda.current_stream(dev.device).synchronize()
    else:
        out = dev.clone()
    with _LOCK:
        _STATS["d2h_readbacks"] += 1
        _STATS["d2h_bytes"] += out.numel() * out.element_size()
    return out


def handoff_stats() -> dict:
    """Copies by kind and the bytes each way."""
    with _LOCK:
        stats = dict(_STATS)
    total = stats["h2d_pinned"] + stats["h2d_pageable"]
    stats["h2d_transfers"] = total
    stats["h2d_pinned_frac"] = stats["h2d_pinned"] / total if total else 0.0
    return stats


def reset_handoff_stats() -> None:
    with _LOCK:
        for key in _STATS:
            _STATS[key] = 0
