"""Functional optimizers on flat ``[n, P]`` peer-stacked buffers.

Each reproduces the update math of the optax transformation the reference
examples use, elementwise and per peer, so one call updates every peer's
replica.  Updates run in place on the optimizer state; the caller adds the
returned updates to the parameters (``optax.apply_updates``).

- :func:`sgd` — ``optax.sgd`` (with or without momentum);
- :func:`adam` — ``optax.adam``;
- :func:`adamw` — ``optax.adamw``: Adam's update plus ``wd·p``, which is
  why ``update_`` takes the parameters (the others ignore them);
- :func:`lora_optimizer` — the reference's ``lora_optimizer``
  (``optax.multi_transform`` of an optimizer on the LoRA leaves and
  ``set_to_zero`` on the rest): a :class:`Masked` optimizer whose state and
  updates cover only the trainable leaves.  The stacked train step takes
  gradients of those leaves alone, and never adds to the frozen ones, so
  they stay bit-identical to their initial values.

Every optimizer has a ``trainable`` name predicate, None when every leaf
trains; the flat buffer places the leaves it selects first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(lr, momentum)``: with momentum, the trace
    ``t ← g + momentum·t`` (``optax.trace``, not Nesterov), then the update
    ``−lr·t``; without momentum the update is ``−lr·g``."""

    lr: float
    momentum: float | None = None
    trainable = None  # every leaf trains (see Masked)

    def init(self, params: torch.Tensor) -> torch.Tensor | None:
        """The optimizer state for ``params``: the zero trace, or None."""
        return torch.zeros_like(params) if self.momentum else None

    def update_(self, grads: torch.Tensor, state: torch.Tensor | None,
                params: torch.Tensor | None = None) -> torch.Tensor:
        """Advance ``state`` in place by ``grads``; return the updates."""
        if state is None:
            return grads * (-self.lr)
        torch.add(grads, state, alpha=self.momentum, out=state)
        return state * (-self.lr)


def sgd(lr: float, momentum: float | None = None) -> SGD:
    return SGD(lr, momentum)


@dataclasses.dataclass
class AdamState:
    """Adam's first and second moments (``[n, P]``) and its step count."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: int = 0


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr)`` with optax's defaults b1 = 0.9, b2 = 0.999,
    eps = 1e-8 and eps_root = 0: the moments ``m ← (1−b1)·g + b1·m`` and
    ``v ← (1−b2)·g² + b2·v``, bias-corrected by ``1 − b^t`` in float32 with
    an int32 count ``t``, and the update ``−lr · m̂ / (√(v̂ + eps_root) +
    eps)``."""

    lr: float
    trainable = None  # every leaf trains (see Masked)
    b1 = 0.9
    b2 = 0.999
    eps = 1e-8
    eps_root = 0.0

    def init(self, params: torch.Tensor) -> AdamState:
        """Zero moments shaped like ``params`` and a count of 0."""
        return AdamState(torch.zeros_like(params), torch.zeros_like(params))

    def update_(self, grads: torch.Tensor, state: AdamState,
                params: torch.Tensor | None = None) -> torch.Tensor:
        """Advance ``state`` in place by ``grads``; return the updates."""
        return self._scaled(grads, state).mul_(-self.lr)

    def _scaled(self, grads: torch.Tensor, state: AdamState) -> torch.Tensor:
        """``optax.scale_by_adam``: advance the moments, return m̂ / (√v̂ + ε)."""
        # optax's ``(1 − b)·g + b·m``, each product rounded (XLA does not
        # fuse these into one FMA).
        state.mu.mul_(self.b1).add_(grads * (1.0 - self.b1))
        state.nu.mul_(self.b2).add_(grads.square().mul_(1.0 - self.b2))
        state.count = min(state.count + 1, 2**31 - 1)  # optax's safe_increment
        # optax: ``1 - decay ** count`` with the count cast to float32.
        t = np.float32(state.count)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        denom = (state.nu / bc2).add_(self.eps_root).sqrt_().add_(self.eps)
        return (state.mu / bc1).div_(denom)


def adam(lr: float) -> Adam:
    return Adam(lr)


@dataclasses.dataclass(frozen=True)
class AdamW(Adam):
    """``optax.adamw(lr, weight_decay)`` with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8, no mask, so every leaf decays, LayerNorm and biases
    included): ``scale_by_adam``, then ``add_decayed_weights``
    (:meth:`decayed_`), then ``−lr``."""

    weight_decay: float = 1e-4

    def update_(self, grads: torch.Tensor, state: AdamState,
                params: torch.Tensor | None = None) -> torch.Tensor:
        """Advance ``state`` in place by ``grads``; return the updates of
        ``params`` (needed: the decay is proportional to them)."""
        if params is None:
            raise ValueError("adamw's update needs the parameters")
        return self.decayed_(self._scaled(grads, state), params).mul_(-self.lr)

    def decayed_(self, updates: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        """``optax.add_decayed_weights``: ``updates + wd·params`` in place,
        as one fused multiply-add (``addcmul`` is one on the CPU and on the
        card), the form the reference's compiled step computes."""
        wd = torch.full((), self.weight_decay, dtype=updates.dtype, device=updates.device)
        return updates.addcmul_(params, wd)


def adamw(lr: float, weight_decay: float = 1e-4) -> AdamW:
    return AdamW(lr, weight_decay)


@dataclasses.dataclass(frozen=True)
class Masked:
    """An optimizer over the leaves whose name ``trainable`` selects, the
    rest frozen (``set_to_zero``).  Its state and its updates are ``[n, T]``
    over the trainable leaves alone, packed in the flat buffer's order
    (:meth:`~dpwa_tpu_torch.utils.pytree.FlatParams.pack`); the frozen
    leaves get neither state nor gradients, which is what the reference's
    exact-zero updates leave them with."""

    base: Any
    trainable: Callable[[str], bool]

    def init(self, params: torch.Tensor) -> Any:
        """The base optimizer's state for the packed trainable ``[n, T]``."""
        return self.base.init(params)

    def update_(self, grads: torch.Tensor, state: Any,
                params: torch.Tensor | None = None) -> torch.Tensor:
        """The base optimizer's update of the packed trainable gradients
        (``params``: the packed trainable parameters)."""
        return self.base.update_(grads, state, params)


def lora_optimizer(base_opt, is_lora: Callable[[str], bool]) -> Masked:
    """The reference's ``lora_optimizer(base_opt, params)``: train the
    leaves ``is_lora`` selects (``models.llama.lora_filter``) with
    ``base_opt`` and hard-freeze the rest."""
    return Masked(base_opt, is_lora)
