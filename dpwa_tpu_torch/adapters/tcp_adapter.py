"""Per-process adapters over the TCP transport (the port of
:mod:`dpwa_tpu.adapters.tcp_adapter`).

- :class:`DpwaTcpAdapter` holds a tree of tensors ``{name: tensor}`` in one
  flat buffer on the card; each :meth:`~DpwaTcpAdapter.update` gathers it
  into the reference's frame order (``ravel_pytree`` of the reference's
  tree, kernels in the reference's layouts where the tree's
  :attr:`~dpwa_tpu_torch.utils.pytree.Leaves.axes` say so), runs
  one gossip round on the card, and scatters the merge back: one gather
  and one scatter.  So a port node and a ``dpwa_tpu`` node merge the same
  elements.
- :class:`DpwaTorchAdapter` (alias :data:`DpwaPyTorchAdapter`) is the
  reference's PyTorch user surface: ``adapter.update(loss)`` after
  ``optimizer.step()``, the model's parameters flattened in
  ``model.parameters()`` order and torch layout, as the reference flattens
  them, the flat vector on the model's device.

Not ported yet: the recovery plane around the round (serving the state
for a peer's bootstrap, ``bootstrap=True`` or ``DPWA_BOOTSTRAP=1``, the
rollback ring and its local guard, re-sync), the membership, trust and
tune events, and the metrics records; the remote guard before each merge
is the transport's and runs.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Union

import torch

from dpwa_tpu_torch.config import DpwaConfig, load_config
from dpwa_tpu_torch.parallel.tcp import TcpTransport
from dpwa_tpu_torch.utils.pytree import FlatParams, layout_axes, leaf_order


def _resolve(config: Union[DpwaConfig, str]) -> DpwaConfig:
    return load_config(config) if isinstance(config, str) else config


def _no_bootstrap(bootstrap: Optional[bool]) -> None:
    if bootstrap is None:
        bootstrap = os.environ.get("DPWA_BOOTSTRAP", "0") == "1"
    if bootstrap:
        raise NotImplementedError(
            "bootstrap from a peer (recovery's STATE wire) is not ported to "
            "dpwa_tpu_torch yet"
        )


class DpwaTcpAdapter:
    """One node's replica of a tree of tensors, gossiped over TCP.

    ``params`` (``{name: tensor}``, copied) go into one float32 buffer on
    the transport's device (the CUDA card by default, ``device="cpu"`` on
    purpose); a :class:`~dpwa_tpu_torch.utils.pytree.Leaves` tree (the
    port's ResNet and ConvNet ``init``) names the leaves the port lays out
    otherwise than the reference, so that the frame carries the
    reference's element order.  ``transport``
    takes an already built :class:`TcpTransport` for this node.
    :attr:`params` are views of the buffer (:attr:`flat`, one row, for an
    optimizer over the flat buffer): train them in place, or pass new
    values to :meth:`update`."""

    def __init__(
        self,
        params: Mapping[str, torch.Tensor],
        name: str,
        config: Union[DpwaConfig, str],
        *,
        device=None,
        transport: Optional[TcpTransport] = None,
        bootstrap: Optional[bool] = None,
    ):
        _no_bootstrap(bootstrap)
        self.config = _resolve(config)
        self.transport = transport if transport is not None else TcpTransport(
            self.config, name, device=device
        )
        device = self.transport.device
        names = leaf_order(params)
        self.flat = FlatParams(
            names, [tuple(params[k].shape) for k in names], 1, device=device,
            axes=layout_axes(params),
        )
        for k, view in self.flat.views().items():
            view[0].copy_(params[k])
        self._order = torch.as_tensor(self.flat.reference_order(), device=device)
        self._clock = 0.0
        self._step = 0
        self.last_alpha = 0.0
        self.last_partner = -1
        # Serve the initial weights at once, as the reference does.
        self.transport.publish(self.vector(), self._clock, 0.0)

    @property
    def params(self) -> dict:
        """``{name: tensor}`` views of the replica."""
        return {k: v[0] for k, v in self.flat.views().items()}

    @property
    def step(self) -> int:
        return self._step

    def vector(self) -> torch.Tensor:
        """The replica as the reference's flat vector (a new tensor)."""
        return self.flat.flat[0].index_select(0, self._order)

    def update(self, loss: float, params: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
        """One gossip round: the clock advances, the replica (``params`` if
        given, copied in) is published and merged with this step's partner;
        returns :attr:`params`."""
        if params is not None:
            for k, view in self.flat.views().items():
                if view[0].data_ptr() != params[k].data_ptr():
                    view[0].copy_(params[k])
        self._clock += 1.0
        step = self._step
        vec = self.vector()
        merged, self.last_alpha, self.last_partner = self.transport.exchange_on_device(
            vec, self._clock, float(loss), step
        )
        self._step = step + 1
        if merged is not vec:
            self.flat.flat[0].index_copy_(0, self._order, merged)
        return self.params

    def close(self) -> None:
        self.transport.close()


class DpwaTorchAdapter:
    """The reference's ``DpwaPyTorchAdapter(model, name, config)`` with
    ``update(loss)``: the model's parameters, flattened in
    ``model.parameters()`` order, gossiped from the model's device (the
    transport's ring pinned when that is the card)."""

    def __init__(self, model: torch.nn.Module, name: str, config: Union[DpwaConfig, str],
                 bootstrap: Optional[bool] = None):
        _no_bootstrap(bootstrap)
        self.model = model
        self.config = _resolve(config)
        first = next(model.parameters(), None)
        device = first.device if first is not None else "cpu"
        self.transport = TcpTransport(self.config, name, device=device)
        self._clock = 0.0
        self._step = 0
        self.last_alpha = 0.0
        self.last_partner = -1
        self.transport.publish(self._flatten(), self._clock, 0.0)

    def _flatten(self) -> torch.Tensor:
        with torch.no_grad():
            parts = [p.detach().reshape(-1).to(torch.float32) for p in self.model.parameters()]
        return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float32)

    def _unflatten_into_model(self, vec: torch.Tensor) -> None:
        offset = 0
        with torch.no_grad():
            for p in self.model.parameters():
                n = p.numel()
                p.copy_(vec[offset:offset + n].view(p.shape))
                offset += n

    def update(self, loss: float) -> None:
        """The reference's per-step call, after ``optimizer.step()``."""
        self._clock += 1.0
        merged, self.last_alpha, self.last_partner = self.transport.exchange_on_device(
            self._flatten(), self._clock, float(loss), self._step
        )
        self._step += 1
        if self.last_alpha != 0.0:
            self._unflatten_into_model(merged)

    def close(self) -> None:
        self.transport.close()


# The reference's class name.
DpwaPyTorchAdapter = DpwaTorchAdapter
