"""Host-side threefry2x32 draws, bit-equal to ``jax.random``.

The port of the ``jax.random`` calls that the schedules make on the host
(:mod:`dpwa_tpu.parallel.schedules`), in numpy ``uint32`` arithmetic:
``Schedule.branch`` picks a pool row on the host every step, so these run
on the CPU and never on the card.

What is matched is jax's default generator (``jax_default_prng_impl =
threefry2x32``) with its default partitionable bit generation
(``jax_threefry_partitionable = True``, the default from jax 0.5 on):

- :func:`key` — ``jax.random.key(seed)`` for a 32-bit seed: the key
  ``(seed >> 32, seed & 0xFFFFFFFF)`` with the high word 0;
- :func:`fold_in` — ``threefry2x32(key, (0, data))``;
- :func:`split` — child ``i`` is ``threefry2x32(key, (0, i))`` (the
  partitionable split counts with a 64-bit iota);
- :func:`random_bits` — for a scalar, ``y0 ^ y1`` of
  ``threefry2x32(key, (0, 0))``;
- :func:`randint` — jax's ``_randint``: two words from the two halves of a
  split, combined modulo the span so the bias is that of a 64-bit draw.

``uniform``, ``permutation``, the participation and fault draws and the
int8 wire's stochastic rounding are not ported yet; the settings that need
them raise in :func:`dpwa_tpu_torch.parallel.schedules.build_schedule`.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = tuple[int, int]


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: Key, count: tuple[int, int]) -> tuple[int, int]:
    """The 20-round Threefry-2x32 block cipher of ``jax.random``'s
    ``threefry2x32_p`` on one pair of 32-bit words."""
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (count[0] + ks[0]) & _MASK
    x1 = (count[1] + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed that fits int32 (jax's default
    without x64 mode): high word 0, low word the seed's bits."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32")
    return 0, seed & _MASK


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` with ``data`` taken as uint32."""
    return threefry2x32(k, (0, int(data) & _MASK))


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)`` under partitionable threefry."""
    return [threefry2x32(k, (0, i)) for i in range(num)]


def random_bits(k: Key) -> int:
    """One 32-bit word of ``jax.random.bits(k)`` at shape ``()``."""
    y0, y1 = threefry2x32(k, (0, 0))
    return y0 ^ y1


def randint(k: Key, minval: int, maxval: int) -> int:
    """``jax.random.randint(k, (), minval, maxval)`` (int32): a scalar in
    ``[minval, maxval)``, or ``minval`` when ``maxval <= minval``."""
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not -(2**31) <= v < 2**31:
            raise ValueError(f"randint bound {v} does not fit int32")
    k1, k2 = split(k)
    higher, lower = random_bits(k1), random_bits(k2)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    multiplier = ((2**16 % span) ** 2 & _MASK) % span
    offset = ((higher % span) * multiplier + lower % span) & _MASK
    return minval + offset % span
