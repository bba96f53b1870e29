"""Divergence guard: one definition of a sane replica, and the rollback
ring (the port of :mod:`dpwa_tpu.recovery.guard`).

:func:`validate_payload` has two callers, so "sane" cannot drift between
them: the TCP transport runs it on every fetched frame while
``recovery.enabled`` (the default), before the merge (a well-formed frame
that carries a sick replica is not merged and the fetch is classified
``poisoned``); and the TCP adapter runs it on its own replica before each
round, rolling the replica back to the newest :class:`RollbackRing`
snapshot when it fails.  The checks run where the vector lies, the card
included, in float64 for the norm as the reference's; only two scalars
come back to the host.  The norm's sum runs in another order than numpy's,
so a vector whose norm sits within float64 rounding of a bound may be
judged differently; nothing else differs.

The ring keeps its snapshots where the replica is: ``capacity`` buffers
made once, at the first push; a push is one device-to-device copy.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Optional

import numpy as np
import torch

from dpwa_tpu_torch.config import RecoveryConfig


def payload_checks(vec) -> tuple[bool, float]:
    """``(all finite, float64 L2 norm)`` of ``vec`` (a tensor on any
    device, or a numpy array), with one readback."""
    v = torch.from_numpy(np.ascontiguousarray(vec)) if isinstance(vec, np.ndarray) else vec
    v = v.reshape(-1)
    finite = torch.isfinite(v).all().to(torch.float64)
    norm = torch.linalg.vector_norm(v, dtype=torch.float64)
    ok, value = torch.stack([finite, norm]).tolist()
    return bool(ok), float(value)


def validate_payload(
    vec,
    loss: float,
    config: RecoveryConfig,
    local_norm: Optional[float] = None,
) -> Optional[str]:
    """None if ``(vec, loss)`` is a sane replica, else the violation, one of
    the reference's strings: ``nonfinite_params`` | ``param_norm`` |
    ``zero_energy`` | ``nonfinite_loss`` | ``loss_bound``.

    ``vec`` is the frame's payload (float32 or bf16, checked in float64);
    ``local_norm`` the receiver's own replica norm, against which a remote
    below ``min_param_norm_ratio`` of it is ``zero_energy``."""
    finite, norm = payload_checks(vec)
    if not finite:
        return "nonfinite_params"
    if norm > config.max_param_norm:
        return "param_norm"
    if (
        config.min_param_norm_ratio > 0.0
        and local_norm is not None
        and local_norm > 0.0
        and norm < config.min_param_norm_ratio * local_norm
    ):
        return "zero_energy"
    l = float(loss)
    if math.isnan(l) or math.isinf(l):
        return "nonfinite_loss"
    if abs(l) > config.max_loss:
        return "loss_bound"
    return None


@dataclasses.dataclass
class Snapshot:
    """One last-good ring entry: the replica and the schedule coordinates
    it was banked at.  From :meth:`RollbackRing.rollback`, ``vec`` is the
    ring's own buffer, valid until the next push: copy it out first."""

    vec: torch.Tensor
    step: int
    clock: float
    loss: float

    def copy(self) -> "Snapshot":
        return Snapshot(self.vec.clone(), self.step, self.clock, self.loss)


class RollbackRing:
    """A ring of last-good replica snapshots on the replica's device.

    Pushed on healthy steps (every ``snapshot_every``), popped when the
    local replica trips the guard.  :meth:`rollback` consumes the newest
    entry, so a replica that re-diverges right after a restore digs one
    snapshot deeper instead of bouncing on the same state.  The contents
    are a function of the push/rollback sequence alone, as the
    reference's."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._slots: Optional[torch.Tensor] = None  # [capacity, *shape], made once
        self._held: deque = deque()  # (slot, step, clock, loss), oldest first
        self.pushes = 0
        self.rollbacks = 0

    def __len__(self) -> int:
        return len(self._held)

    def push(self, vec: torch.Tensor, step: int, clock: float, loss: float) -> None:
        """Bank a healthy snapshot: one copy of ``vec`` into a slot on its
        device (the oldest entry's slot when the ring is full)."""
        if self._slots is None:
            self._slots = torch.empty(
                (self.capacity, *vec.shape), dtype=vec.dtype, device=vec.device
            )
        elif self._slots.shape[1:] != vec.shape or self._slots.dtype != vec.dtype:
            raise ValueError(
                f"ring holds {self._slots.dtype}{list(self._slots.shape[1:])}, "
                f"got {vec.dtype}{list(vec.shape)}"
            )
        if len(self._held) == self.capacity:
            self._held.popleft()
        used = {entry[0] for entry in self._held}
        slot = next(i for i in range(self.capacity) if i not in used)
        self._slots[slot].copy_(vec)
        self._held.append((slot, int(step), float(clock), float(loss)))
        self.pushes += 1

    def newest(self) -> Optional[Snapshot]:
        """The newest snapshot, copied, without consuming it."""
        if not self._held:
            return None
        slot, step, clock, loss = self._held[-1]
        return Snapshot(self._slots[slot].clone(), step, clock, loss)

    def rollback(self) -> Optional[Snapshot]:
        """Consume and return the newest good snapshot (None if empty)."""
        if not self._held:
            return None
        self.rollbacks += 1
        slot, step, clock, loss = self._held.pop()
        return Snapshot(self._slots[slot], step, clock, loss)

    def clear(self) -> None:
        self._held.clear()
