"""Zigzag ring attention: the causal ring with its work balanced over the
ranks (the port of :mod:`dpwa_tpu.ops.zigzag_ring`).

The sequence is cut into ``2·sp`` chunks and rank i holds chunks ``(i,
2·sp−1−i)``: an early stripe e and a late stripe l.  At every hop each rank
then runs the same work through the hop kernels B3/B4: ``e_i × e_src``
(causal rule), ``l_i × e_src`` (always full) and ``l_i × l_src`` (reversed
rule).  The ring itself is :mod:`dpwa_tpu_torch.ops.flash_ring`'s, with the
zigzag hop plan.  Callers order their tokens and targets with
:func:`zigzag_shard`; the model gives rope the matching
:func:`zigzag_positions`.
"""

from __future__ import annotations

import torch

from dpwa_tpu_torch.ops.flash_ring import ring_flash_attention


def zigzag_order(sp: int) -> list[int]:
    """The global chunk order that contiguous sharding over ``sp`` ranks
    turns into rank i holding chunks ``(i, 2·sp−1−i)``."""
    order = []
    for i in range(sp):
        order.append(i)
        order.append(2 * sp - 1 - i)
    return order


def zigzag_shard(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    """A global sequence axis permuted into zigzag chunk order.  Inverse:
    :func:`zigzag_unshard`."""
    t = x.shape[axis]
    if t % (2 * sp):
        raise ValueError(f"sequence length {t} not divisible by 2*sp={2 * sp}")
    chunks = torch.chunk(x, 2 * sp, dim=axis)
    return torch.cat([chunks[c] for c in zigzag_order(sp)], dim=axis)


def zigzag_unshard(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard`."""
    chunks = torch.chunk(x, 2 * sp, dim=axis)
    inv = [0] * (2 * sp)
    for pos, c in enumerate(zigzag_order(sp)):
        inv[c] = pos
    return torch.cat([chunks[inv[c]] for c in range(2 * sp)], dim=axis)


def zigzag_positions_local(t_local: int, sp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s global rope positions under the zigzag layout:
    chunk ``rank``, then chunk ``2·sp−1−rank``."""
    c = t_local // 2
    return torch.cat([torch.arange(c) + rank * c, torch.arange(c) + (2 * sp - 1 - rank) * c])


def zigzag_positions(t: int, sp: int, device=None) -> torch.Tensor:
    """The global positions of a zigzag-sharded sequence of ``t`` tokens,
    rank after rank."""
    return torch.cat([zigzag_positions_local(t // sp, sp, r) for r in range(sp)]).to(device)


def zigzag_ring_attention(q, k, v, sp: int, impl=None) -> torch.Tensor:
    """Causal ring attention over ``sp`` virtual ranks in the zigzag layout
    (the port of ``zigzag_ring_attention_local``): ``q [B, T, H, D]`` and
    ``k, v [B, T, KV, D]`` with each rank's block its early then its late
    stripe.  ``impl``: "flash" (B3/B4 on the card, their plain versions on
    the CPU), "jnp" (the reference's twin arithmetic) or None (the kernels
    when a half stripe is eligible on the card, else the twins)."""
    return ring_flash_attention(q, k, v, sp, causal=True, impl=impl, layout="zigzag")
