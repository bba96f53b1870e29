"""Merge-coefficient (α) strategies for ``x ← (1−α)·x + α·x_peer``.

The port of :mod:`dpwa_tpu.interpolation`.  Where the reference maps one
peer's ``(clock, loss)`` pair to a scalar and is vmapped over the stacked
axis, these map ``[n]`` tensors (one entry per peer) to an ``[n]`` float32
α in one pass of elementwise ops, with the same float32 arithmetic, so the
α of every peer is the reference's bit for bit.

- **constant** — fixed α; α = 0.5 is the ``(local+remote)/2`` merge.
- **clock-weighted** — α = factor · remote_clock / (local + remote clock).
- **loss-weighted** — α = factor · local_loss / (local + remote loss).

The TCP transport also passes ``trust_scale``, the content-trust plane's
damping of the current exchange, multiplied in after the clamp.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from dpwa_tpu_torch.config import InterpolationConfig

_EPS = 1e-8


class PeerMeta(NamedTuple):
    """Per-peer scalars that ride along with every exchange, as ``[n]``
    float32 tensors: ``clock`` counts training steps, ``loss`` is the most
    recent training loss."""

    clock: torch.Tensor
    loss: torch.Tensor


# An interpolation maps (local_meta, remote_meta) -> alpha[n] in [0, 1].
Interpolation = Callable[[PeerMeta, PeerMeta], torch.Tensor]


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def constant(factor: float) -> Interpolation:
    def alpha(local: PeerMeta, remote: PeerMeta) -> torch.Tensor:
        del remote
        return torch.full_like(local.clock, factor, dtype=torch.float32)

    return alpha


def clock_weighted(factor: float = 1.0) -> Interpolation:
    """α = factor · remote_clock / (local_clock + remote_clock).

    A fresh peer (clock 0) contributes nothing; two equally-trained peers
    average symmetrically (α = factor/2)."""

    def alpha(local: PeerMeta, remote: PeerMeta) -> torch.Tensor:
        total = local.clock + remote.clock
        return _f32(factor, total) * remote.clock / torch.maximum(
            total, _f32(_EPS, total)
        )

    return alpha


def loss_weighted(factor: float = 1.0) -> Interpolation:
    """α = factor · local_loss / (local_loss + remote_loss).

    The higher my loss relative to the peer's, the more of the peer I take."""

    def alpha(local: PeerMeta, remote: PeerMeta) -> torch.Tensor:
        total = local.loss + remote.loss
        return _f32(factor, total) * local.loss / torch.maximum(
            total, _f32(_EPS, total)
        )

    return alpha


def _clamped(
    strategy: Interpolation,
    max_abs_loss: float | None = None,
    trust_scale: Callable[[], float] | None = None,
) -> Interpolation:
    """Restrict α to [0, 1] so the merge is always an interpolation, and
    resolve sick metadata as the reference does.

    "Sick" means non-finite metadata (NaN/inf clock or loss) and, when
    ``max_abs_loss`` is given (``RecoveryConfig.rescue_bound()``), a finite
    loss beyond that bound.  A sick LOCAL side with a healthy remote gets
    α = 1 (adopt the healthy peer: the rescue gossip offers a diverged
    replica); every other non-finite α becomes 0; a sick REMOTE never
    merges (α = 0).  Then α is clipped to [0, 1], and multiplied by
    ``clip(float32(trust_scale()), 0, 1)`` when ``trust_scale`` is given:
    a fully trusted peer's 1.0 leaves α bit for bit as it was."""

    def alpha(local: PeerMeta, remote: PeerMeta) -> torch.Tensor:
        a = strategy(local, remote)
        local_ok = torch.isfinite(local.clock) & torch.isfinite(local.loss)
        remote_ok = torch.isfinite(remote.clock) & torch.isfinite(remote.loss)
        if max_abs_loss is not None:
            bound = _f32(max_abs_loss, a)
            local_ok = local_ok & (local.loss.abs() <= bound)
            remote_ok = remote_ok & (remote.loss.abs() <= bound)
        one, zero = _f32(1.0, a), _f32(0.0, a)
        rescue = torch.where(~local_ok & remote_ok, one, zero)
        a = torch.where(torch.isfinite(a) & local_ok, a, rescue)
        a = torch.where(remote_ok, a, zero)
        a = torch.clamp(a, 0.0, 1.0)
        if trust_scale is not None:
            a = a * torch.clamp(_f32(trust_scale(), a), 0.0, 1.0)
        return a

    return alpha


def make_interpolation(
    config: InterpolationConfig,
    max_abs_loss: float | None = None,
    trust_scale: Callable[[], float] | None = None,
) -> Interpolation:
    """Factory from the YAML ``interpolation:`` section; every strategy is
    clamped to α ∈ [0, 1] and damped by ``trust_scale`` (see
    :func:`_clamped`)."""
    if config.type == "constant":
        return _clamped(constant(config.factor), max_abs_loss, trust_scale)
    if config.type == "clock":
        return _clamped(clock_weighted(config.factor), max_abs_loss, trust_scale)
    if config.type == "loss":
        return _clamped(loss_weighted(config.factor), max_abs_loss, trust_scale)
    raise ValueError(f"unknown interpolation type {config.type!r}")
