"""Single-device gossip over a stacked virtual-peer axis.

The port of :mod:`dpwa_tpu.parallel.stacked`.  Every replica lives in one
flat ``[n_peers, P]`` float32 buffer (:class:`~dpwa_tpu_torch.utils.pytree.
FlatParams`) on one card, and one gossip round is:

1. pick this step's pool row (``schedule.branch(step)``, on the host);
2. with ``fetch_probability < 1`` or ``drop_probability > 0``, each pair's
   participation and fault draws, on the host from the host's step
   (:meth:`~dpwa_tpu_torch.parallel.schedules.Schedule.drawn`), copied to
   the card as one ``[n]`` bool mask from pinned memory without waiting;
3. α from each peer's and its partner's ``(clock, loss)``, masked to 0 for
   peers that sit the round out — elementwise ops on ``[n]`` tensors on the
   device, the reference's float32 arithmetic;
4. on the int8 wire, each sender's rows quantized and dequantized leaf by
   leaf with the sender's keys (:func:`~dpwa_tpu_torch.ops.quantize.
   fake_quant_rows`) into a second buffer ``w``: what each peer ships;
5. the merge ``x ← (1−α)·x + α·y[partner]``, ``y`` = ``x`` or ``w``: for a
   pairwise schedule ONE launch of the in-place pair-merge kernel B1 over
   the row's pair list (one per contiguous column range under
   ``exchange_filter``); for a pull schedule, whose maps are not
   involutions, the gather-merge kernel B2.

The pool's partner maps and pair lists go to the device once, when the
transport is built; a step picks a row of them, so the exchange waits on
nothing.  The merged values are the reference's bit for bit
(``tests/test_torch_stacked.py``, ``tests/test_torch_exchange.py``).

Model state (BatchNorm's running statistics, ``with_state=True``) is merged
with the parameters, same pairs, same α, same wire, as the reference merges
the tuple ``(params, model_state)``.  :func:`init_stacked_state` places the
state's columns right after the parameters' in one buffer
(:func:`~dpwa_tpu_torch.utils.pytree.stack_with_state`), outside the
optimizer's leading range, so a step without ``exchange_filter`` merges
both in ONE launch of B1 (one per contiguous column range otherwise).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dpwa_tpu_torch.config import DpwaConfig
from dpwa_tpu_torch.interpolation import PeerMeta, make_interpolation
from dpwa_tpu_torch.ops.merge import (
    empty_rows_like,
    gather_merge,
    involution_pairs,
    pair_merge_,
)
from dpwa_tpu_torch.ops.quantize import WirePlan, fake_quant_rows
from dpwa_tpu_torch.parallel import schedules
from dpwa_tpu_torch.utils import trace
from dpwa_tpu_torch.utils.devices import resolve_device
from dpwa_tpu_torch.utils.pytree import FlatParams, joint_flat, stack_with_state

Columns = Sequence[Tuple[int, int]]


class ExchangeInfo(NamedTuple):
    partner: torch.Tensor  # int32[n]: this round's partner (or pull source)
    alpha: torch.Tensor  # float32[n]: merge coefficient, 0 when sitting out
    participated: torch.Tensor  # bool[n]


class DevicePool:
    """A schedule's pool resident on the device.

    ``partner`` is the ``[K, n]`` int32 pool; for a pairwise schedule
    ``left``/``right`` hold each row's pair lists (:func:`involution_pairs`
    with ``self_pairs``: the real pairs, then every peer that sits the
    round out as a pair ``(i, i)``), zero-filled to one length ``[K, k]``;
    :meth:`pairs` gives a row's lists cut to their length, which stays on
    the host.  Built from the host pool, which
    :func:`~dpwa_tpu_torch.parallel.schedules.build_schedule` has already
    checked, so the kernels' row indices are valid."""

    def __init__(self, schedule: schedules.Schedule, device):
        pool = np.asarray(schedule.pool)
        n = schedule.n_peers
        if pool.ndim != 2 or pool.shape[1] != n or pool.min() < 0 or pool.max() >= n:
            raise ValueError(f"schedule pool must be [K, {n}] indices in [0, {n})")
        self.partner = torch.as_tensor(pool, dtype=torch.int32, device=device)
        self.me = torch.arange(n, device=device)
        self.left = self.right = None
        self.counts: list[int] = []
        if schedule.mode == "pairwise":
            lists = [involution_pairs(row, self_pairs=True) for row in pool]
            self.counts = [len(left) for left, _ in lists]
            k = max(self.counts)
            left = np.zeros((len(pool), k), np.int32)
            right = np.zeros((len(pool), k), np.int32)
            for row, (lo, ro) in enumerate(lists):
                left[row, : len(lo)], right[row, : len(ro)] = lo, ro
            self.left = torch.as_tensor(left, device=device)
            self.right = torch.as_tensor(right, device=device)

    def pairs(self, branch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pool row ``branch``'s (left, right) pair lists on the device."""
        k = self.counts[branch]
        return self.left[branch, :k], self.right[branch, :k]


def _host_mask(mask: np.ndarray, device) -> torch.Tensor:
    """A host bool mask on ``device``: on the card through pinned memory,
    copied without waiting (the caching host allocator keeps the pinned
    block until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(mask))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def stacked_gossip_exchange(
    x: torch.Tensor,
    meta: PeerMeta,
    step: int,
    *,
    schedule: schedules.Schedule,
    interp,
    pool: DevicePool | None = None,
    columns: Columns | None = None,
    out: torch.Tensor | None = None,
    plan: WirePlan | None = None,
    w: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, ExchangeInfo]:
    """One gossip round over the float32 ``[n, d]`` stacked buffer ``x``:
    returns the merged replicas and the round's :class:`ExchangeInfo`.

    ``meta`` holds ``[n]`` float32 clocks and losses; ``step`` (an int)
    selects the pool row and keys the round's draws.  ``columns`` restricts
    the merge to column ranges ``[lo, hi)`` (the others stay
    bit-identical); None merges every column.  ``pool`` is the schedule's
    :class:`DevicePool` on ``x``'s device (built here when not given).

    On the int8 wire, ``plan`` names the shipped leaves' columns in the
    order whose index keys their draws (default: each range of
    ``columns``, or the whole row, as one leaf) and ``w`` (``[n, d]``
    float32, not sharing ``x``'s storage; allocated when not given)
    receives every sender's dequantized rows there.

    A pairwise round merges ``x`` in place (B1) and returns it; a peer that
    sits the round out is merged with its own shipped row at α = 0, as the
    reference merges it (finite values stay bit-identical, an inf becomes
    NaN).  A pull round merges out of place (B2): into ``out`` (``[n, d]``,
    not sharing ``x``'s storage), which it returns with ``x`` left as it
    was; without ``out``, or under ``columns``, it copies the result back
    into ``x``."""
    if pool is None:
        pool = DevicePool(schedule, x.device)
    if out is not None and (schedule.mode != "pull" or columns is not None):
        raise ValueError("out is only for a pull round over every column")
    branch = schedule.branch(step)
    partner = pool.partner[branch]
    remote = PeerMeta(meta.clock[partner], meta.loss[partner])
    participated = partner != pool.me
    if schedule.draws:
        drawn = schedule.drawn(step, schedule.pool[branch])
        participated = participated & _host_mask(drawn, x.device)
    alpha = torch.where(participated, interp(meta, remote), 0.0)
    alpha = alpha.to(torch.float32).contiguous()
    wire = schedule.wire_dtype
    ranges = [(0, x.shape[1])] if columns is None else list(columns)
    if wire == "int8":
        if plan is None:
            plan = WirePlan(ranges, x.device)
        if w is None:
            w = empty_rows_like(x)
        fake_quant_rows(x, w, plan, schedule.seed, step)
    info = ExchangeInfo(partner, alpha, participated)
    if out is not None:
        return gather_merge(x, partner, alpha, wire=wire, out=out, w=w), info
    for lo, hi in ranges:
        part = x[:, lo:hi]
        w_part = None if w is None else w[:, lo:hi]
        if schedule.mode == "pull":
            part.copy_(gather_merge(part, partner, alpha, wire=wire, w=w_part))
        else:
            left, right = pool.pairs(branch)
            pair_merge_(part, left, right, alpha, wire=wire, self_pairs=True, w=w_part)
    return x, info


class StackedTransport:
    """Virtual-peer gossip on one device.

    The YAML config is the same one that drives the reference's transports:
    the length of ``nodes:`` sets the stacked-axis size, host/port entries
    are ignored.  ``device`` defaults to the CUDA card (and raises without
    one); pass ``device="cpu"`` to run the plain merges on the CPU.  On the
    int8 wire the transport keeps the wire buffer and each leaf layout's
    :class:`~dpwa_tpu_torch.ops.quantize.WirePlan` across steps."""

    def __init__(self, config: DpwaConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.schedule = schedules.build_schedule(config)
        self.interp = make_interpolation(
            config.interpolation,
            max_abs_loss=(
                config.recovery.rescue_bound() if config.recovery.enabled else None
            ),
        )
        self.pool = DevicePool(self.schedule, self.device)
        self._plans: dict[tuple, WirePlan] = {}
        self._wire: torch.Tensor | None = None

    def _wire_args(self, x: torch.Tensor, leaves: Columns | None) -> dict:
        """On the int8 wire, the plan for ``leaves`` and a wire buffer
        shaped and aligned like ``x``, both kept for the next step."""
        if self.schedule.wire_dtype != "int8":
            return {}
        key = tuple(map(tuple, leaves))
        if key not in self._plans:
            self._plans[key] = WirePlan(leaves, x.device)
        w = self._wire
        if w is None or w.shape != x.shape or w.data_ptr() % 16 != x.data_ptr() % 16:
            self._wire = w = empty_rows_like(x)
        return {"plan": self._plans[key], "w": w}

    def exchange(
        self, x: torch.Tensor, meta: PeerMeta, step: int,
        columns: Columns | None = None, leaves: Columns | None = None,
    ) -> Tuple[torch.Tensor, ExchangeInfo]:
        """One gossip round over every stacked replica of ``x`` ``[n, d]``,
        in place (see :func:`stacked_gossip_exchange`).  ``leaves`` are the
        int8 wire's leaf ranges (default: each range of ``columns``, or the
        whole row, as one leaf)."""
        if leaves is None:
            leaves = [(0, x.shape[1])] if columns is None else columns
        return stacked_gossip_exchange(
            x, meta, int(step), schedule=self.schedule, interp=self.interp,
            pool=self.pool, columns=columns, **self._wire_args(x, leaves),
        )

    def exchange_params(
        self, params: FlatParams, meta: PeerMeta, step: int,
        pred: Callable[[str], bool] | None = None,
    ) -> ExchangeInfo:
        """One gossip round over a :class:`FlatParams` holder, in place,
        over the leaves ``pred`` selects (all when None); on the int8 wire
        each is its own leaf, indexed in the reference's flatten order of
        the exchanged tree.  A pull round over every column writes B2's
        result into the holder's spare buffer and swaps it in, so it
        neither allocates nor copies."""
        columns = None if pred is None else params.column_ranges(pred)
        leaves = params.wire_leaves(pred) if self.schedule.wire_dtype == "int8" else None
        if self.schedule.mode == "pull" and columns is None:
            _, info = stacked_gossip_exchange(
                params.flat, meta, int(step), schedule=self.schedule,
                interp=self.interp, pool=self.pool, out=params.spare_flat(),
                **self._wire_args(params.flat, leaves),
            )
            params.swap()
            return info
        return self.exchange(params.flat, meta, step, columns, leaves)[1]


@dataclasses.dataclass
class StackedTrainState:
    """Stacked training state; every per-peer tensor's leading axis is
    n_peers.  ``model_state`` (a :class:`FlatParams` sharing the
    parameters' buffer, or None) holds BatchNorm's running statistics.
    ``loss`` is each peer's most recent training loss (the metadata an
    overlapped exchange ships).  The train step updates the state in
    place."""

    params: FlatParams
    opt_state: Any
    clock: torch.Tensor  # float32[n]
    step: int
    model_state: Any = None
    loss: Optional[torch.Tensor] = None  # float32[n]


def init_stacked_state(
    stacked_params: "FlatParams | Mapping[str, torch.Tensor]",
    optimizer,
    transport: StackedTransport,
    stacked_model_state: Any = None,
) -> StackedTrainState:
    """Training state on the transport's device from peer-stacked params.

    The optimizer's ``trainable`` leaves (all for an unmasked one) go in
    the leading columns of the flat buffer, so its state, its updates and a
    matching exchange filter each cover one column range; the state holds
    the trainable leaves only.  A :class:`FlatParams` already laid out so
    (built with ``first=optimizer.trainable``, as
    :func:`~dpwa_tpu_torch.train.init_params_per_peer` does) on the
    transport's device becomes the state's buffer, updated in place by the
    train step: the caller hands it over, as the reference donates its
    state.  Anything else (``{name: [n, *shape]}``, another layout) is
    copied into a new buffer.

    ``stacked_model_state`` (``{name: [n, *shape]}`` or a
    :class:`FlatParams`, e.g. BatchNorm's running statistics) is copied
    with the parameters into one new buffer, its columns right after
    theirs (:func:`~dpwa_tpu_torch.utils.pytree.stack_with_state`).  The
    parameters keep their layouts (:class:`~dpwa_tpu_torch.utils.pytree.
    Leaves`, or a :class:`FlatParams`' own) for the wire."""
    n = transport.config.n_peers
    trainable = optimizer.trainable
    as_dict = lambda t: t.leaves() if isinstance(t, FlatParams) else t
    for what, tree in (("params", stacked_params), ("model state", stacked_model_state)):
        if tree is None:
            continue
        leading = {int(v.shape[0]) for v in as_dict(tree).values()}
        if leading != {n}:
            raise ValueError(
                f"stacked {what} must have leading peer axis {n}, got {leading}"
            )
    params, model_state = stacked_params, None
    if stacked_model_state is not None:
        params, model_state = stack_with_state(
            as_dict(params), as_dict(stacked_model_state),
            device=transport.device, first=trainable,
        )
    elif not (
        isinstance(params, FlatParams)
        and params.first is trainable
        and params.buffer.device == transport.device
    ):
        params = FlatParams.stack(as_dict(params), device=transport.device, first=trainable)
    return StackedTrainState(
        params=params,
        opt_state=optimizer.init(params.pack(params.views(), trainable)),
        clock=torch.zeros(n, dtype=torch.float32, device=transport.device),
        step=0,
        model_state=model_state,
        loss=torch.zeros(n, dtype=torch.float32, device=transport.device),
    )


def make_stacked_train_step(
    loss_fn: Callable[[Mapping[str, torch.Tensor], Any], torch.Tensor],
    optimizer,
    transport: StackedTransport,
    exchange_filter: Optional[Callable[[str], bool]] = None,
    with_state: bool = False,
    overlap: bool = False,
):
    """``train_step(state, batch) -> (state, losses, info)`` on one device:
    per-peer forward/backward (``torch.func.vmap`` of ``grad``), the
    optimizer on the flat buffer, and the stacked gossip exchange — the
    port of the reference's ``make_stacked_train_step``.

    ``loss_fn(params, batch)`` is one peer's scalar loss, with ``params`` a
    ``{name: tensor}`` dict of that peer's parameters and ``batch`` that
    peer's slice of the peer-stacked ``(x[n, b, ...], y[n, b])``.  With
    ``with_state=True`` it is ``loss_fn(params, model_state, batch) ->
    (loss, new_model_state)``, both states ``{name: tensor}`` dicts (e.g.
    :func:`~dpwa_tpu_torch.models.resnet.apply_batch_norm`'s statistics);
    the state then needs ``stacked_model_state`` at
    :func:`init_stacked_state`, and the new statistics are merged with the
    parameters (``overlap=True``: the old ones are merged and this step's
    change ``new − old`` added, as the reference does).

    The reference donates its state; here ``state`` is updated **in place**
    (parameters, optimizer state, clock, step and loss) and returned.

    ``exchange_filter(name)`` limits the exchange to the matching
    parameters (their column ranges of the flat buffer); the rest train
    locally and never move.  ``overlap=True`` exchanges the PRE-update
    replicas with the previous step's losses as metadata and adds this
    step's updates to the merged result, as the reference does.

    With a masked optimizer (one whose ``trainable`` name predicate is not
    None, such as :func:`~dpwa_tpu_torch.optim.lora_optimizer`) the
    gradient is taken with respect to the trainable leaves alone: the
    frozen ones get no gradient, no optimizer state and no update, and stay
    bit-identical — the reference computes their gradients and multiplies
    them by zero."""
    if with_state:
        def split_loss(train, frozen, model_state, batch):
            return loss_fn({**frozen, **train}, model_state, batch)

        grad_fn = torch.func.vmap(torch.func.grad_and_value(split_loss, has_aux=True))

        def per_peer(train, frozen, model_state, batch):
            grads, (losses, new_model_state) = grad_fn(train, frozen, model_state, batch)
            return grads, losses, new_model_state
    else:
        def split_loss(train, frozen, batch):
            return loss_fn({**frozen, **train}, batch)

        per_peer = torch.func.vmap(torch.func.grad_and_value(split_loss))
    return make_step_from_grads(per_peer, optimizer, transport, exchange_filter, overlap,
                                with_state)


def _state_columns(params: FlatParams, model_state: FlatParams,
                   pred: Callable[[str], bool] | None) -> Tuple[list, list]:
    """The exchange's column ranges and int8 leaves over :func:`joint_flat`:
    the parameters ``pred`` selects, then every column of the state (the
    reference's flatten order of ``(params, model_state)``), adjacent
    ranges merged."""
    shift = lambda ranges: [(params.ld + r[0], params.ld + r[1], *r[2:]) for r in ranges]
    columns = []
    for lo, hi in params.column_ranges(pred) + shift(model_state.column_ranges()):
        if columns and columns[-1][1] == lo:
            columns[-1] = (columns[-1][0], hi)
        else:
            columns.append((lo, hi))
    leaves = params.wire_leaves(pred) + shift(model_state.wire_leaves())
    return columns, leaves


def make_step_from_grads(
    grads_and_losses: Callable[..., tuple],
    optimizer,
    transport: StackedTransport,
    exchange_filter: Optional[Callable[[str], bool]] = None,
    overlap: bool = False,
    with_state: bool = False,
):
    """The stacked train step around ``grads_and_losses(train, frozen,
    batch) -> (grads, losses)``, which gives every peer's gradients of the
    ``train`` leaves (``{name: [n, ...]}``) and its float ``[n]`` losses
    (with ``with_state``: ``grads_and_losses(train, frozen, model_state,
    batch) -> (grads, losses, new_model_state)``): the optimizer on the
    flat buffer, then the exchange, as :func:`make_stacked_train_step`
    describes.  The sequence-parallel step (:mod:`dpwa_tpu_torch.train_sp`)
    shares it."""
    trainable = optimizer.trainable  # None: every leaf

    def train_step(state: StackedTrainState, batch):
        # The reference's misuse guards: silently frozen statistics are
        # worse than an error.
        if not with_state and state.model_state is not None:
            raise ValueError(
                "state carries model_state but this step was built with "
                "with_state=False, which would never update it; pass "
                "with_state=True"
            )
        if with_state and state.model_state is None:
            raise ValueError(
                "step built with with_state=True but state.model_state is "
                "None; pass stacked_model_state to init_stacked_state"
            )
        params, model_state = state.params, state.model_state
        views = params.views()
        train = {k: v for k, v in views.items() if trainable is None or trainable(k)}
        frozen = {k: v for k, v in views.items() if k not in train}
        with trace.span("step.grads"):
            if with_state:
                grads, losses, new_model_state = grads_and_losses(
                    train, frozen, model_state.views(), batch)
            else:
                grads, losses = grads_and_losses(train, frozen, batch)
        with trace.span("step.optimizer"):
            packed = params.pack(grads, trainable)
            del grads  # the packed copy is all the optimizer reads
            # The current parameters in the packed layout (AdamW decays
            # them): the buffer's leading columns, where init_stacked_state
            # places the trainable leaves.
            width = packed.shape[1]
            if params.column_ranges(trainable) != [(0, width)]:
                raise ValueError("the trainable leaves must lead the flat buffer "
                                 "(build the state with init_stacked_state)")
            updates = optimizer.update_(packed, state.opt_state, params.flat[:, :width])
            del packed
        losses = losses.to(torch.float32)
        clock = state.clock + 1.0
        with trace.span("step.exchange"):
            if with_state:
                info = _exchange_with_state(
                    transport, params, model_state, model_state.pack(new_model_state),
                    updates, trainable, exchange_filter, clock,
                    state.loss if overlap else losses, state.step, overlap,
                )
            elif overlap:
                prev = state.loss if state.loss is not None else torch.zeros_like(clock)
                info = transport.exchange_params(
                    params, PeerMeta(clock, prev), state.step, exchange_filter
                )
                params.add_(updates, trainable)
            else:
                params.add_(updates, trainable)
                info = transport.exchange_params(
                    params, PeerMeta(clock, losses), state.step, exchange_filter
                )
        state.clock, state.step, state.loss = clock, state.step + 1, losses
        return state, losses, info

    return train_step


def _exchange_with_state(transport, params, model_state, new_state, updates, trainable,
                         exchange_filter, clock, loss, step, overlap) -> ExchangeInfo:
    """The exchange of the parameters and the model state together, in place
    over their shared buffer: the updated parameters with ``new_state``
    ``[n, S]``; or, with ``overlap``, the pre-update ones with the old state,
    after which the updates and the state's change ``new − old`` are added."""
    x = joint_flat(params, model_state)
    columns, leaves = _state_columns(params, model_state, exchange_filter)
    if transport.schedule.wire_dtype != "int8":
        leaves = None
    if loss is None:
        loss = torch.zeros_like(clock)
    if overlap:
        delta = new_state - model_state.flat
        _, info = transport.exchange(x, PeerMeta(clock, loss), step, columns, leaves)
        params.add_(updates, trainable)
        model_state.add_(delta)
    else:
        params.add_(updates, trainable)
        model_state.flat.copy_(new_state)
        _, info = transport.exchange(x, PeerMeta(clock, loss), step, columns, leaves)
    return info
