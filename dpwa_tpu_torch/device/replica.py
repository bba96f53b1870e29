"""A replica that lives on the card, with a lazy host mirror of what it
publishes (the port of :class:`dpwa_tpu.device.replica.DeviceReplica`).

The TCP wire needs host bytes, so a round reads the replica back to
publish it; :class:`DeviceReplica` reads it back at most once per merge.
:meth:`~DeviceReplica.payload` encodes the wire's payload on the replica's
device (float32 as it is, or rounded to bf16 there, so only the wire's
bytes cross) and keeps the host copy until :meth:`~DeviceReplica.swap`
adopts a merge's output: a skipped round republishes the mirror without a
new readback.  A torch tensor can change in place, so the mirror also
records the tensor's version counter and is read anew once it moves.  The
mirror is a snapshot, immutable by convention: the server sends from it
while the next round runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from dpwa_tpu_torch.device import handoff


def bf16_wire(x: torch.Tensor) -> torch.Tensor:
    """float32 → bf16 as the reference's wire rounds it (``ml_dtypes``:
    round to nearest even, a NaN to the quiet NaN of its sign), with
    integer operations on ``x``'s device.  ``Tensor.to(torch.bfloat16)``
    gives another NaN."""
    bits = x.contiguous().view(torch.int32)
    nearest = (bits + (0x7FFF + ((bits >> 16) & 1))) >> 16
    quiet_nan = ((bits >> 16) & 0x8000) | 0x7FC0
    out = torch.where(torch.isnan(x), quiet_nan, nearest)
    return out.to(torch.int16).view(torch.bfloat16)


class DeviceReplica:
    """One worker's flat float32 replica across gossip rounds."""

    __slots__ = ("dev", "_mirror", "_norm", "readbacks", "mirror_hits")

    def __init__(self, dev: torch.Tensor):
        if dev.dtype != torch.float32 or dev.dim() != 1:
            raise ValueError(f"a replica is a flat float32 vector, got {dev.dtype}{list(dev.shape)}")
        self.dev = dev
        self._mirror: Optional[tuple] = None
        self._norm: Optional[tuple] = None
        self.readbacks = 0
        self.mirror_hits = 0

    def payload(self, wire: str) -> torch.Tensor:
        """The wire payload (float32, or bf16 on the bf16 wire) as a host
        snapshot, read back only if the replica changed since the last
        call (a merge landed, or the tensor was written in place)."""
        key = (wire, self.dev._version)
        if self._mirror is not None and self._mirror[0] == key:
            self.mirror_hits += 1
            return self._mirror[1]
        host = handoff.to_host(bf16_wire(self.dev) if wire == "bf16" else self.dev)
        self._mirror = (key, host)
        self.readbacks += 1
        return host

    def norm(self) -> float:
        """The replica's float64 L2 norm (the guard's local norm), once per
        version of the replica."""
        if self._norm is None or self._norm[0] != self.dev._version:
            norm = float(torch.linalg.vector_norm(self.dev, dtype=torch.float64))
            self._norm = (self.dev._version, norm)
        return self._norm[1]

    def swap(self, new_dev: torch.Tensor) -> None:
        """Adopt a merge's output as the replica; the mirror is dropped
        (the server keeps serving the old snapshot until the next publish)."""
        self.dev = new_dev
        self._mirror = None
        self._norm = None
