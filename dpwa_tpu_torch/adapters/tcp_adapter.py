"""Per-process adapters over the TCP transport (the port of
:mod:`dpwa_tpu.adapters.tcp_adapter`).

- :class:`DpwaTcpAdapter` holds a tree of tensors ``{name: tensor}`` in one
  flat buffer on the card; each :meth:`~DpwaTcpAdapter.update` gathers it
  into the reference's frame order (``ravel_pytree`` of the reference's
  tree, kernels in the reference's layouts where the tree's
  :attr:`~dpwa_tpu_torch.utils.pytree.Leaves.axes` say so), runs
  one gossip round on the card, and scatters the merge back: one gather
  and one scatter.  So a port node and a ``dpwa_tpu`` node merge the same
  elements.  With ``recovery.enabled`` (the default) it also runs the
  reference's recovery around the round: the local guard rolls a sick
  replica back to the newest snapshot of a
  :class:`~dpwa_tpu_torch.recovery.guard.RollbackRing` on the card (the
  frame then carries the snapshot's loss); the state a peer bootstraps
  from is published after each round; ``bootstrap=True`` (or
  ``DPWA_BOOTSTRAP=1``, which a restart supervisor sets) lands on a
  healthy donor's replica, clock and step; and re-sync advice adopts a
  donor's replica and clock under ``recovery.auto_resync``.  It gives the
  trust screen the model's leaf sizes in the frame's order, drains the
  membership and trust events into :attr:`~DpwaTcpAdapter.events`, and
  acts on the membership plane's heal advice
  (:meth:`~DpwaTcpAdapter._reconcile_heal`): a drawn donor of the
  returning component's state, guarded, merged on the card.
- :class:`DpwaTorchAdapter` (alias :data:`DpwaPyTorchAdapter`) is the
  reference's PyTorch user surface: ``adapter.update(loss)`` after
  ``optimizer.step()``, the model's parameters flattened in
  ``model.parameters()`` order and torch layout, as the reference flattens
  them, the flat vector on the model's device.  As the reference's, it runs
  no recovery around the round; the transport's guard and health run.

Each round's exchange record (the reference's metrics record: step,
loss, α, the scheduled and actual partner, the remap, the outcome, the
trust verdict and, when a hedge fired, its winner) is
:attr:`DpwaTcpAdapter.last_record`.  Not ported yet: the tune events and
the metrics files.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Mapping, Optional, Union

import numpy as np
import torch

from dpwa_tpu_torch.config import DpwaConfig, load_config
from dpwa_tpu_torch.parallel.schedules import heal_draw
from dpwa_tpu_torch.parallel.tcp import TcpTransport
from dpwa_tpu_torch.recovery.guard import RollbackRing, validate_payload
from dpwa_tpu_torch.recovery.state_transfer import pack_state, unpack_state
from dpwa_tpu_torch.utils.pytree import FlatParams, layout_axes, leaf_order, leaf_sizes


# The adapter keeps this many of its newest events.
EVENT_LOG_CAP = 10000


def _resolve(config: Union[DpwaConfig, str]) -> DpwaConfig:
    return load_config(config) if isinstance(config, str) else config


def _packer(vec: torch.Tensor, meta: dict):
    """A callable packing ``[vec]`` with ``meta`` when a peer first asks:
    ``vec`` (nobody writes it again) is read back then, after the work
    that made it (an event on its stream)."""
    event = None
    if vec.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(vec.device))

    def pack() -> bytes:
        if event is not None:
            event.synchronize()
        return pack_state([vec.cpu()], meta=meta)

    return pack


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
    values to :meth:`update`.  ``bootstrap`` (default: ``DPWA_BOOTSTRAP=1``
    in the environment) fetches a healthy donor's state first and lands on
    its replica, clock and :attr:`step` (:attr:`last_bootstrap`).
    :attr:`events` keeps the newest ``EVENT_LOG_CAP`` events of the
    membership and trust planes and of the heal's reconciliation
    (``partition_reconciled`` or why it was not), each with the step that
    runs next."""

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
        # The screen's per-leaf statistic follows the model's leaves.
        self.transport.set_trust_leaves(leaf_sizes(params))
        self.events: deque = deque(maxlen=EVENT_LOG_CAP)
        self._clock = 0.0
        self._step = 0
        self._last_loss = 0.0
        self.last_alpha = 0.0
        self.last_partner = -1
        self.last_record: dict = {}
        rec = self.config.recovery
        self._recovery = rec if rec.enabled else None
        self.ring: Optional[RollbackRing] = RollbackRing(rec.snapshot_ring) if rec.enabled else None
        self.last_bootstrap: Optional[dict] = None
        self.last_rollback: Optional[dict] = None
        self.last_resync_advice: Optional[dict] = None
        if bootstrap is None:
            bootstrap = os.environ.get("DPWA_BOOTSTRAP", "0") == "1"
        if bootstrap and rec.enabled:
            self._bootstrap_from_peer()
        # Serve the initial weights at once, as the reference does.
        vec = self.vector()
        self.transport.publish(vec, self._clock, self._last_loss)
        if self._recovery is not None:
            self._publish_state(vec)

    @property
    def params(self) -> dict:
        """``{name: tensor}`` views of the replica."""
        return {k: v[0] for k, v in self.flat.views().items()}

    @property
    def step(self) -> int:
        return self._step

    @property
    def clock(self) -> float:
        return self._clock

    def vector(self) -> torch.Tensor:
        """The replica as the reference's flat vector (a new tensor)."""
        return self.flat.flat[0].index_select(0, self._order)

    def health_snapshot(self) -> dict:
        """Per-peer health (:meth:`TcpTransport.health_snapshot`)."""
        return self.transport.health_snapshot()

    # -- recovery -------------------------------------------------------
    def _meta(self) -> dict:
        return {"kind": "tcp_adapter", "clock": self._clock, "step": self._step,
                "loss": self._last_loss}

    def _packed_state(self) -> bytes:
        """This node's whole state as a peer bootstraps from it: the
        replica in the reference's element order, with its clock, next
        step and loss."""
        return _packer(self.vector(), self._meta())()

    def _publish_state(self, vec: torch.Tensor) -> None:
        """Serve :meth:`_packed_state` of the replica ``vec`` (the
        reference order, a tensor nobody writes again), packed at the first
        request: a round that no peer bootstraps from reads nothing back."""
        self.transport.publish_state(_packer(vec, self._meta()))

    def _land(self, vec: np.ndarray) -> bool:
        """Adopt a donor's flat vector (the reference order) as the
        replica: one copy to the device and one scatter."""
        vec = np.asarray(vec, dtype=np.float32)
        if vec.shape != (self.flat.size,):
            return False
        self.flat.flat[0].index_copy_(0, self._order, torch.from_numpy(vec).to(self.flat.flat.device))
        return True

    def _bootstrap_from_peer(self) -> bool:
        """Fetch a healthy donor's state and land on its schedule step."""
        from dpwa_tpu_torch.recovery.bootstrap import bootstrap_from_peer

        res = bootstrap_from_peer(self.transport, like=None, step=self._step)
        if res is None or not res.state or not self._land(res.state[0]):
            return False
        self._clock = float(res.meta.get("clock", 0.0))
        self._step = int(res.meta.get("step", 0))
        self._last_loss = float(res.meta.get("loss", 0.0))
        self.last_bootstrap = {
            "donor": res.donor, "step": self._step, "clock": self._clock,
            "nbytes": res.nbytes, "attempts": res.attempts,
            "latency_s": res.latency_s, "meta": res.meta,
        }
        return True

    def _resync(self) -> bool:
        """Adopt a healthy donor's replica and clock, keeping the step:
        this node never left the ring, so its schedule position is right
        and only its replica is stale."""
        from dpwa_tpu_torch.recovery.bootstrap import bootstrap_from_peer

        res = bootstrap_from_peer(self.transport, like=None, step=self._step)
        if res is None or not res.state or not self._land(res.state[0]):
            return False
        self._clock = float(res.meta.get("clock", self._clock))
        return True

    def _guard_local(self, loss: float) -> None:
        """Roll the replica back to the newest good snapshot when this
        step's (replica, loss) trips the guard; the checks run on the
        card, with one two-scalar readback."""
        reason = validate_payload(self.flat.flat[0], loss, self._recovery)
        if reason is None:
            return
        snap = self.ring.rollback()
        if snap is not None:
            # The replica only: clock and step stay monotonic, so the
            # pairing sequence every peer draws is untouched.
            self.flat.flat[0].copy_(snap.vec)
            self._last_loss = snap.loss
        self.last_rollback = {
            "step": self._step, "reason": reason, "restored": snap is not None,
            "snapshot_step": snap.step if snap is not None else None,
        }

    def update(self, loss: float, params: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
        """One gossip round: the clock advances, the replica (``params`` if
        given, copied in) is guarded, published and merged with this step's
        partner; returns :attr:`params`."""
        if params is not None:
            for k, view in self.flat.views().items():
                if view[0].data_ptr() != params[k].data_ptr():
                    view[0].copy_(params[k])
        loss = float(loss)
        rolled_back = False
        if self._recovery is not None:
            before = self.last_rollback
            self._guard_local(loss)
            rolled_back = self.last_rollback is not before
            if rolled_back:
                # The snapshot's loss rides the frame, not the sick one
                # (the partner's guard would take us for poisoned).
                loss = self._last_loss
        self._clock += 1.0
        step = self._step
        vec = self.vector()
        merged, self.last_alpha, self.last_partner = self.transport.exchange_on_device(
            vec, self._clock, loss, step
        )
        # The packed state's step is the next one to run: a rejoiner
        # bootstrapping from it makes the draw this node makes next.
        self._step = step + 1
        if merged is not vec:
            self.flat.flat[0].index_copy_(0, self._order, merged)
        self._record(step, loss)
        if self._recovery is not None:
            self._last_loss = loss
            if not rolled_back and step % self._recovery.snapshot_every == 0:
                self.ring.push(self.flat.flat[0], step, self._clock, loss)
            self._publish_state(merged)
            advice = self.transport.pop_resync_advice()
            if advice is not None:
                self.last_resync_advice = advice
                if self._recovery.auto_resync:
                    self._resync()
        for ev in self.transport.pop_membership_events() + self.transport.pop_trust_events():
            self._event(**ev)
        heal = self.transport.pop_heal_advice()
        if heal is not None and self.config.membership.heal_reconcile and self._recovery is not None:
            self._reconcile_heal(heal)
        return self.params

    def _record(self, step: int, loss: float) -> None:
        """:attr:`last_record`: this round's exchange, with the reference's
        field names (the trust and hedge columns only when they apply)."""
        info = self.transport.last_round
        rec = {"step": step, "loss": loss, "alpha": self.last_alpha,
               **{k: info.get(k) for k in ("sched_partner", "partner", "remapped", "outcome")}}
        if "trust" in info:
            rec["trust_verdict"] = info["trust"].get("verdict")
            rec["trust_scale"] = info["trust"].get("alpha_scale")
        if info.get("hedged"):
            rec["hedged"] = True
            rec["hedge_winner"] = info.get("hedge_winner")
        self.last_record = rec

    def _event(self, event: str, **fields) -> None:
        """An event record, at the step that runs next (the reference
        adapter's event records carry the same step)."""
        self.events.append({"step": self._step, "event": event, **fields})

    def _reconcile_heal(self, advice: dict) -> None:
        """Anti-entropy merge with a returning component after a heal: one
        returning node's state over the STATE wire, guarded, the replica
        banked in the rollback ring, then merged with the advice's weight
        and guarded again.  The donor is :func:`heal_draw`'s.  The merge is
        the reference's numpy ``((1 - w) * x + w * y)`` in float32: two
        rounded products and a rounded sum (not B2's fused form), on the
        card."""
        me = self.transport.me
        returning = sorted(p for p in advice.get("returning", []) if p != me)
        if not returning:
            return
        donor = returning[heal_draw(
            self.transport.schedule.seed, int(advice.get("step", self._step)), me, len(returning)
        )]
        blob, outcome, _lat, nbytes = self.transport.fetch_state(donor)
        if not blob:
            self._event("partition_reconcile_failed", donor=donor, outcome=outcome)
            return
        try:
            state, meta = unpack_state(blob, like=None)
        except ValueError as e:
            self._event("partition_reconcile_rejected", donor=donor, reason=str(e))
            return
        if not state:
            self._event("partition_reconcile_rejected", donor=donor, reason="empty_state")
            return
        remote = np.asarray(state[0], dtype=np.float32)
        if remote.shape != (self.flat.size,):
            self._event("partition_reconcile_rejected", donor=donor, reason="shape_mismatch")
            return
        x = self.vector()
        y = torch.from_numpy(remote).to(x.device)
        reason = validate_payload(
            y, float(meta.get("loss", 0.0)), self._recovery,
            local_norm=float(torch.linalg.vector_norm(x, dtype=torch.float64)),
        )
        if reason is not None:
            self._event("partition_reconcile_rejected", donor=donor, reason=reason)
            return
        # Bank the replica first: a sick merge rolls back on the usual path.
        self.ring.push(self.flat.flat[0], self._step, self._clock, self._last_loss)
        w = float(advice.get("weight", 0.5))
        merged = reconcile_merge(x, y, w)
        reason = validate_payload(merged, self._last_loss, self._recovery)
        if reason is not None:
            self._event("partition_reconcile_rejected", donor=donor, reason=reason,
                        stage="merged")
            return
        self.flat.flat[0].index_copy_(0, self._order, merged)
        self._event("partition_reconciled", donor=donor, weight=w, nbytes=nbytes,
                    returning=returning)

    def close(self) -> None:
        self.transport.close()


def reconcile_merge(x: torch.Tensor, y: torch.Tensor, w: float) -> torch.Tensor:
    """The heal's merge ``(1 - w)·x + w·y`` in float32 as numpy rounds
    ``((1.0 - w) * x + w * y)`` with the weights as float32 scalars: each
    product rounded, then the sum (two kernels, so nothing fuses)."""
    a = torch.tensor(1.0 - w, dtype=torch.float32, device=x.device)
    b = torch.tensor(w, dtype=torch.float32, device=x.device)
    return torch.add(torch.mul(x, a), torch.mul(y, b))


class DpwaTorchAdapter:
    """The reference's ``DpwaPyTorchAdapter(model, name, config)`` with
    ``update(loss)``: the model's parameters, flattened in
    ``model.parameters()`` order, gossiped from the model's device (the
    transport's ring pinned when that is the card)."""

    def __init__(self, model: torch.nn.Module, name: str, config: Union[DpwaConfig, str]):
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
