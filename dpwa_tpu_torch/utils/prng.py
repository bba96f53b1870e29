"""Threefry2x32 draws, bit-equal to ``jax.random``.

The port of the ``jax.random`` calls of the reference.  What is matched is
jax's default generator (``jax_default_prng_impl = threefry2x32``) with its
default partitionable bit generation (``jax_threefry_partitionable =
True``, the default from jax 0.5 on).

Scalars, in Python integer arithmetic on the host (the schedules'
per-step draws, :mod:`dpwa_tpu.parallel.schedules`):

- :func:`key` — ``jax.random.key(seed)`` for a 32-bit seed: the key
  ``(seed >> 32, seed & 0xFFFFFFFF)`` with the high word 0;
- :func:`fold_in` — ``threefry2x32(key, (0, data))``;
- :func:`split` — child ``i`` is ``threefry2x32(key, (0, i))`` (the
  partitionable split counts with a 64-bit iota);
- :func:`random_bits` — for a scalar, ``y0 ^ y1`` of
  ``threefry2x32(key, (0, 0))``;
- :func:`randint` — jax's ``_randint``: two words from the two halves of a
  split, combined modulo the span so the bias is that of a 64-bit draw.

Tensors, in int64 torch arithmetic masked to 32 bits on the caller's
device, in chunks (the models' initial parameters, drawn on the card at
Llama-3-8B width):

- :func:`random_bits_tensor` — ``jax.random.bits(key, shape)``: element
  ``i`` (flat, row-major) is ``y0 ^ y1`` of ``threefry2x32(key, (i >> 32,
  i & 0xFFFFFFFF))``;
- :func:`uniform` — ``jax.random.uniform``: the top 23 bits as a float in
  [1, 2), minus 1, scaled into [minval, maxval); bit-equal;
- :func:`normal`, :func:`truncated_normal` — ``√2 · erfinv(u)`` as jax
  draws them, through a port of XLA's float32 ``ErfInv`` polynomial (the
  one of its ``chlo.erf_inv`` lowering) and of the CPU backend's float32
  ``log1p`` (Cephes' rational near 0, Eigen's ``plog`` of 1 + x beyond).
  XLA contracts the polynomials' steps into fused multiply-adds, which
  ``torch.addcmul`` reproduces (a fused multiply-add on the CPU and on the
  card).  Over 2^20 draws from key 0 on the CPU, ``truncated_normal`` was
  bit-equal to jax's and 25 of ``normal``'s values differed by an ulp or
  two: in erfinv's branch for |x| > 0.9966 XLA takes ``√w`` from the host's
  approximate square root, which is not correctly rounded.

- :func:`uniform_scalar` — ``jax.random.uniform(k)`` at shape ``()``, the
  schedules' participation and fault draws;
- :func:`threefry_words` — the cipher on tensors, with the key's words
  tensors too where each element has its own key (the int8 wire's
  stochastic rounding, :mod:`dpwa_tpu_torch.ops.quantize`).

``permutation`` is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

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


def uniform_scalar(k: Key) -> np.float32:
    """``jax.random.uniform(k)`` at shape ``()`` in [0, 1): the top 23 bits
    of :func:`random_bits` as the mantissa of a float in [1, 2), minus 1."""
    one_two = np.array((random_bits(k) >> 9) | 0x3F800000, np.uint32).view(np.float32)
    return one_two - np.float32(1.0)


# ---------------------------------------------------------------------------
# Tensor draws.
# ---------------------------------------------------------------------------

CHUNK = 1 << 24  # draws computed at once (int64 scratch: about 0.4 GB at this size)
SQRT2 = float(np.float32(math.sqrt(2.0)))  # jax's np.array(np.sqrt(2), float32)
# erf(∓2 / √2) in float32 as jax computes them (erf of float32(∓2) /
# float32(√2)): the ends of truncated_normal's uniform for (lower, upper) =
# (-2, 2).  tests/test_torch_prng.py reads them from jax bit for bit.
ERF_LO_2 = -0.9544997  # bits 0xbf745a18
ERF_HI_2 = 0.9544997  # bits 0x3f745a18
# XLA's ErfInv32: Giles' two 9-term polynomials, in w − 2.5 for
# w = −log1p(−x²) < 5 and in √w − 3 otherwise, highest degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def threefry_words(k, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on int64 tensors of 32-bit words, in place
    (``x0``, ``x1`` are consumed and returned).  The key's two words are
    ints, or int64 tensors that broadcast against ``x0`` (one key per
    element: the int8 wire's per-sender, per-leaf keys)."""
    k0, k1 = k[0] & _MASK, k[1] & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0.add_(ks[0]).bitwise_and_(_MASK)
    x1.add_(ks[1]).bitwise_and_(_MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            hi = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_and_(_MASK).bitwise_xor_(x0)
            del hi
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_((ks[(i + 2) % 3] + i + 1) & _MASK).bitwise_and_(_MASK)
    return x0, x1


def _threefry_tensor(k, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """``y0 ^ y1`` of :func:`threefry_words` (``x0``, ``x1`` are consumed)."""
    y0, y1 = threefry_words(k, x0, x1)
    return y0.bitwise_xor_(y1)


def unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32-bit words: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1 (jax's ``_uniform``)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _scale_unit(f: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``max(minval, f·(maxval − minval) + minval)`` in float32, the product
    and sum fused as XLA fuses them."""
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=f.device) - lo
    return torch.maximum(torch.addcmul(lo, f, span), lo)


def _chunked(k: Key, shape, device, fn, dtype=torch.float32) -> torch.Tensor:
    """``fn(bits)`` over the draws of ``k`` at ``shape``, chunk by chunk,
    into a ``dtype`` tensor on ``device``: draw i's 32-bit word is that of
    the flat index i as the 64-bit counter, high word first."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    for start in range(0, n, CHUNK):
        idx = torch.arange(start, min(start + CHUNK, n), dtype=torch.int64, device=device)
        out[start:start + idx.numel()] = fn(_threefry_tensor(k, idx >> 32, idx & _MASK))
    return out.view(shape)


def random_bits_tensor(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32 words) as an int64 tensor on
    ``device``."""
    return _chunked(k, shape, device, lambda bits: bits, torch.int64)


def uniform(k: Key, shape, minval: float = 0.0, maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``, bit-equal."""
    return _chunked(k, shape, device, lambda b: _scale_unit(unit_floats(b), minval, maxval))


# XLA's float32 log1p on the CPU: Cephes' rational approximation for
# |x| < √2 − 1 (numerator and denominator highest degree first) ...
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# ... and log(1 + x) otherwise, through its vectorised log (Eigen's plog,
# after Cephes' logf).
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _f32(c: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, float(np.float32(c)))


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coefs:
        p = torch.addcmul(_f32(c, x), p, x)
    return p


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log on the CPU for positive finite x (Eigen's plog)."""
    x = torch.clamp_min(x, float(np.array(0x00800000, np.int32).view(np.float32)))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    low = m < float(np.float32(0.707106781186547524))
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    x2 = m * m
    x3 = x2 * m
    ma = lambda a, b, c: torch.addcmul(_f32(c, a), a, b) if isinstance(c, float) else torch.addcmul(c, a, b)
    y = ma(ma(m, _f32(_LOG_P[0], m), _LOG_P[1]), m, _LOG_P[2])
    y1 = ma(ma(m, _f32(_LOG_P[3], m), _LOG_P[4]), m, _LOG_P[5])
    y2 = ma(ma(m, _f32(_LOG_P[6], m), _LOG_P[7]), m, _LOG_P[8])
    y = torch.addcmul(_f32(_LOG_Q1, m) * e, ma(ma(y, x3, y1), x3, y2), x3)
    m = (m - 0.5 * x2) + y
    return m + _f32(_LOG_Q2, m) * e


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p on the CPU, for x > −1."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + torch.addcmul(small, _f32(-0.5, x), x2)
    return torch.where(x.abs() < _LOG1P_SMALL, small, _xla_log(1.0 + x))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv`` (``chlo.erf_inv``): Giles' approximation,
    ±inf at ±1."""
    w = _xla_log1p(x * -x).neg_()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(lt, a, b) for a, b in zip(
        torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device),
        torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device),
    )]
    p = coef[0]
    for c in coef[1:]:
        p = torch.addcmul(c, p, w)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return erfinv(_scale_unit(unit_floats(bits), lo, 1.0)) * SQRT2


def normal(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` in float32: ``√2 · erfinv(u)`` with
    ``u`` uniform in (−1, 1)."""
    return _chunked(k, shape, device, _normal_from_bits)


def _truncated_from_bits(bits: torch.Tensor) -> torch.Tensor:
    out = erfinv(_scale_unit(unit_floats(bits), ERF_LO_2, ERF_HI_2)) * SQRT2
    ends = torch.tensor([-2.0, 2.0], dtype=torch.float32, device=bits.device)
    inner = torch.nextafter(ends, -ends)  # the open interval (-2, 2)
    return out.clamp_(inner[0], inner[1])


def truncated_normal(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.truncated_normal(k, -2, 2, shape)`` in float32: ``√2 ·
    erfinv(u)`` with ``u`` uniform between ``erf(∓√2)``, clipped to the
    open interval (−2, 2)."""
    return _chunked(k, shape, device, _truncated_from_bits)
