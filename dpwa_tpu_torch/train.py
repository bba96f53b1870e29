"""Training helpers of the stacked gossip loop (the port of the parts of
:mod:`dpwa_tpu.train` the stacked path uses).

The stacked train step itself is
:func:`dpwa_tpu_torch.parallel.stacked.make_stacked_train_step`.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from dpwa_tpu_torch.utils import prng
from dpwa_tpu_torch.utils.devices import resolve_device
from dpwa_tpu_torch.utils.pytree import FlatParams, NamePredicate, layout_axes, leaf_order

Params = Mapping[str, torch.Tensor]


def stack_params(params: Params, n_peers: int, device=None) -> FlatParams:
    """One set of parameters replicated on every peer — an identical warm
    start, as the reference's ``stack_params`` (every process builds the
    same model).  Each peer's row of a :class:`FlatParams` on ``device``
    (the CUDA card by default) holds its own copy, since the train step
    updates the buffer in place."""
    device = resolve_device(device)
    names = leaf_order(params)
    flat = FlatParams(
        names, [tuple(params[k].shape) for k in names], n_peers,
        device=device, dtype=params[names[0]].dtype,
    )
    for name, view in flat.views().items():
        view.copy_(params[name].to(device).expand_as(view))
    return flat


def init_params_per_peer(
    init_fn: Callable[[prng.Key], Params],
    key: prng.Key,
    n_peers: int,
    device=None,
    first: NamePredicate | None = None,
) -> FlatParams:
    """Independent random init per peer (a diverged cold start), as the
    reference's ``jax.vmap(init_fn)(jax.random.split(key, n_peers))``: peer
    i's parameters are ``init_fn(prng.split(key, n_peers)[i])`` (e.g.
    ``lambda k: resnet.init(model, k)``, or ``llama.init`` drawing on the
    card), written row by row into a :class:`FlatParams` on ``device`` (the
    CUDA card by default), so that at most one peer's draw exists beside the
    stacked buffer.  ``first`` places the leaves it selects in the leading
    columns: pass the optimizer's ``trainable``, and
    :func:`~dpwa_tpu_torch.parallel.stacked.init_stacked_state` takes the
    buffer over as it is.  The holder takes the leaves' layouts from what
    ``init_fn`` returns (:class:`~dpwa_tpu_torch.utils.pytree.Leaves`: the
    port's ResNet and ConvNet ``init``), for the wire."""
    device = resolve_device(device)
    flat = None
    for i, peer_key in enumerate(prng.split(key, n_peers)):
        peer = init_fn(peer_key)
        if flat is None:
            names = leaf_order(peer)
            flat = FlatParams(
                names, [tuple(peer[k].shape) for k in names], n_peers,
                device=device, dtype=peer[names[0]].dtype, first=first,
                axes=layout_axes(peer),
            )
        views = flat.views()
        for name, value in peer.items():
            views[name][i].copy_(value)
        del peer
    return flat


def softmax_cross_entropy_with_integer_labels(
    logits: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """Per-example ``logsumexp(logits) − logits[label]``, as optax."""
    picked = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - picked


def make_gossip_eval_fn(apply_fn: Callable[[Params, torch.Tensor], torch.Tensor]):
    """``eval_fn(stacked_params, x, y) -> accuracy[n]``: every peer's
    replica on the same test set, the peers vmapped.  ``stacked_params`` is
    a :class:`FlatParams` or ``{name: [n, *shape]}``."""

    def one(params, x, y):
        logits = apply_fn(params, x)
        return (logits.argmax(-1) == y).to(torch.float32).mean()

    per_peer = torch.func.vmap(one, in_dims=(0, None, None))

    def eval_fn(stacked_params, x, y):
        if isinstance(stacked_params, FlatParams):
            stacked_params = stacked_params.views()
        with torch.no_grad():
            return per_peer(stacked_params, x, y)

    return eval_fn
