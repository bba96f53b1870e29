"""Functional optimizers on flat ``[n, P]`` peer-stacked buffers.

Each reproduces the update math of the optax transformation the reference
examples use, elementwise and per peer, so one call updates every peer's
replica.  Updates run in place on the optimizer state; the caller adds the
returned updates to the parameters (``optax.apply_updates``).

Optax Adam (the MNIST example's optimizer) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(lr, momentum)``: with momentum, the trace
    ``t ← g + momentum·t`` (``optax.trace``, not Nesterov), then the update
    ``−lr·t``; without momentum the update is ``−lr·g``."""

    lr: float
    momentum: float | None = None

    def init(self, params: torch.Tensor) -> torch.Tensor | None:
        """The optimizer state for ``params``: the zero trace, or None."""
        return torch.zeros_like(params) if self.momentum else None

    def update_(self, grads: torch.Tensor, state: torch.Tensor | None) -> torch.Tensor:
        """Advance ``state`` in place by ``grads``; return the updates."""
        if state is None:
            return grads * (-self.lr)
        torch.add(grads, state, alpha=self.momentum, out=state)
        return state * (-self.lr)


def sgd(lr: float, momentum: float | None = None) -> SGD:
    return SGD(lr, momentum)
