"""Gossip + sequence-parallel training on one card (the port of
:mod:`dpwa_tpu.train_sp`).

The reference runs a ``(peers, sp)`` mesh: gossip over ``peers`` while each
replica's sequences span its ``sp`` devices through ring attention, the
whole step one ``shard_map`` program.  Here both axes are virtual: the
peers are the stacked leading axis of :mod:`dpwa_tpu_torch.parallel.
stacked`, and the ``sp`` ranks are blocks of each peer's sequence, which
the model's ring (or Ulysses) attention walks in place.  What the
reference's collectives do becomes arithmetic on one card:

- ``psum`` of each rank's ``(loss_sum, count)`` over ``sp`` is the loss sum
  and token count of the whole sequence, which ``loss_fn`` returns;
- the gradient of the replicated parameters, which the reference's
  transpose sums over ``sp``, is the gradient of that sum;
- the loss is ``loss_sum / max(count, 1)`` and the gradient is divided by
  the same, as ``train_sp.py:179-184`` does;
- the exchange, ``exchange_filter`` and ``overlap`` are the stacked step's;
- with model state, each rank's statistics of its own block (a leading
  ``[sp]`` axis on what ``loss_fn`` returns) are averaged over the ranks,
  the reference's ``pmean`` over ``sp``, and then merged with the
  parameters as in the stacked step.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from dpwa_tpu_torch.parallel import virtual_axis
from dpwa_tpu_torch.parallel.stacked import (
    StackedTransport,
    init_stacked_state,
    make_step_from_grads,
)

SP_AXIS = "sp"


def check_sp_sequence(seq_len: int, sp: int, layout: str = "contiguous") -> int:
    """The block length ``T_local`` of a sequence of ``seq_len`` tokens
    over ``sp`` ranks; raises unless ``sp`` (``2·sp`` for the zigzag
    layout) divides it — the counterpart of ``make_sp_mesh``'s checks and of
    the example's (``examples/longcontext/main.py:91-95``)."""
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    div = 2 * sp if layout == "zigzag" else sp
    if seq_len % div:
        what = "2*sp for the zigzag layout" if div != sp else "sp"
        raise ValueError(f"sequence length {seq_len} must divide by {div} ({what})")
    return seq_len // sp


def init_gossip_sp_state(stacked_params, optimizer, transport: StackedTransport,
                         stacked_model_state: Any = None):
    """The stacked training state (:func:`~dpwa_tpu_torch.parallel.stacked.
    init_stacked_state`): on one card the sp ranks share every tensor."""
    return init_stacked_state(stacked_params, optimizer, transport, stacked_model_state)


def make_gossip_sp_train_step(
    loss_fn: Callable[[Any, Any], tuple],
    optimizer,
    transport: StackedTransport,
    exchange_filter: Optional[Callable[[str], bool]] = None,
    overlap: bool = False,
    sp_axis: str = SP_AXIS,
    *,
    sp: int,
):
    """``train_step(state, batch) -> (state, losses, info)`` over stacked
    peers and a virtual axis ``sp_axis`` of ``sp`` ranks.

    ``loss_fn(params, batch) -> (loss_sum, count)``: one peer's summed
    token loss over its whole sequence and the number of tokens (a float
    tensor), with the model's axis bound (the step binds ``sp_axis`` to
    ``sp`` around it).  ``batch`` is a tuple of ``[n_peers, B, T]``
    tensors, ``T`` divisible by ``sp``, in the model's layout order
    (zigzag-sharded for the zigzag layout).  ``losses`` is each peer's mean
    token loss.  ``exchange_filter`` and ``overlap`` are as in
    :func:`~dpwa_tpu_torch.parallel.stacked.make_stacked_train_step`;
    ``state`` is updated in place."""
    return _make_sp_step(loss_fn, optimizer, transport, exchange_filter, overlap, sp_axis,
                         sp, with_state=False)


def make_gossip_sp_train_step_with_state(
    loss_fn: Callable[[Any, Any, Any], tuple],
    optimizer,
    transport: StackedTransport,
    exchange_filter: Optional[Callable[[str], bool]] = None,
    overlap: bool = False,
    sp_axis: str = SP_AXIS,
    *,
    sp: int,
):
    """:func:`make_gossip_sp_train_step` for models with non-parameter
    variables: ``loss_fn(params, model_state, batch) -> ((loss_sum, count),
    new_model_state)``, where each leaf of ``new_model_state`` is
    ``[sp, *shape]``: row ``r`` the statistics that rank ``r`` computes on
    its own block of the sequence.  The step averages them over the ranks
    (the reference's ``pmean`` over ``sp``), so every rank of a replica
    holds the same state, and exchanges them with the parameters, same
    pairs and α, as :func:`~dpwa_tpu_torch.parallel.stacked.
    make_stacked_train_step` with ``with_state=True``.  The state needs
    ``stacked_model_state`` at :func:`init_gossip_sp_state`."""
    return _make_sp_step(loss_fn, optimizer, transport, exchange_filter, overlap, sp_axis,
                         sp, with_state=True)


def _make_sp_step(loss_fn, optimizer, transport, exchange_filter, overlap, sp_axis, sp,
                  with_state: bool):
    if with_state:
        # grad needs a scalar primal: the count and the new state ride as aux.
        def split_loss(train, frozen, model_state, batch):
            (loss_sum, count), new_model_state = loss_fn({**frozen, **train}, model_state, batch)
            return loss_sum, (count, new_model_state)
    else:
        def split_loss(train, frozen, batch):
            return loss_fn({**frozen, **train}, batch)

    per_peer = torch.func.vmap(torch.func.grad_and_value(split_loss, has_aux=True))

    def grads_and_losses(train, frozen, *rest):
        batch = rest[-1]
        for x in batch:
            if x.shape[-1] % sp:
                raise ValueError(f"batch sequence length {x.shape[-1]} is not divisible by sp={sp}")
        with virtual_axis.bind(sp_axis, sp):
            grads, (loss_sum, aux) = per_peer(train, frozen, *rest)
        count, new_model_state = aux if with_state else (aux, None)
        count = count.to(torch.float32).clamp_min(1.0)
        grads = {k: g / count.reshape(-1, *[1] * (g.dim() - 1)).to(g.dtype)
                 for k, g in grads.items()}
        if not with_state:
            return grads, loss_sum / count
        for name, v in new_model_state.items():
            if v.dim() < 2 or v.shape[1] != sp:
                raise ValueError(
                    f"model state {name!r} must come back [sp={sp}, ...] per peer, "
                    f"got {tuple(v.shape[1:])}"
                )
        return grads, loss_sum / count, {k: v.mean(dim=1) for k, v in new_model_state.items()}

    return make_step_from_grads(grads_and_losses, optimizer, transport, exchange_filter, overlap,
                                with_state)
