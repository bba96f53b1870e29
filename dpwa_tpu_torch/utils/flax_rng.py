"""The keys and initialisers of Flax's ``model.init``, bit-equal in the
keys and within 2 float32 ulps in the values.

The reference initialises every peer with ``model.init(key, x)`` (Flax
linen 0.12.3 over jax 0.9.0).  Each ``self.param(name, init_fn, shape)``
there draws from its own key: the root key with the SHA-1 of the
parameter's scope path and the scope's rng counter folded in
(``flax/core/scope.py::_fold_in_static`` and ``Scope.make_rng``, with
``flax_fix_rng_separator`` False, the default).  A scope's counter counts
its ``self.param`` calls from 1, drawing or not (zeros and ones take a key
too), so it depends only on the parameter's place in its module.
:func:`param_key` ports that; the initialisers below draw each leaf in the
reference's shape through :mod:`dpwa_tpu_torch.utils.prng`, and the models'
``init`` lay the values out as their own leaves.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence

import numpy as np
import torch

from dpwa_tpu_torch.utils import prng

TRUNC_STD = 0.87962566103423978  # the std of a unit normal truncated to (-2, 2)


def fold_in_static(key: prng.Key, data: Sequence[str | int]) -> prng.Key:
    """Flax's ``_fold_in_static``: the first 4 bytes of the SHA-1 of
    ``data`` (strings as UTF-8, ints as their minimal big-endian bytes),
    folded into ``key`` as one uint32."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or string, got {x!r}")
    return prng.fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def param_key(root: prng.Key, path: Sequence[str], counter: int) -> prng.Key:
    """The key of the ``counter``-th ``self.param`` (from 1) of the module
    at scope ``path`` (module names from the root, e.g. ``("layer_0",
    "attn", "wq")``) under ``model.init(root, …)``."""
    return fold_in_static(root, (*path, counter))


def compute_fans(shape: Sequence[int], in_axis: int = -2, out_axis: int = -1) -> tuple[float, float]:
    """``jax.nn.initializers``' ``_compute_fans``, in the same float
    arithmetic (the variance is cast to float32 from it)."""
    in_size, out_size = shape[in_axis], shape[out_axis]
    receptive_field_size = math.prod(shape) / in_size / out_size
    return in_size * receptive_field_size, out_size * receptive_field_size


def _f32(x: float) -> np.float32:
    return np.float32(x)


def lecun_normal(key: prng.Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """Flax's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")``: a unit normal truncated to (-2, 2) times
    ``√(1/fan_in) / 0.8796…``, each step in float32 as jax takes it."""
    fan_in, _ = compute_fans(shape)
    std = np.sqrt(_f32(1.0 / fan_in)) / _f32(TRUNC_STD)
    return prng.truncated_normal(key, shape, device=device).mul_(float(std))


def normal(key: prng.Key, shape: Sequence[int], stddev: float, device=None) -> torch.Tensor:
    """``jax.nn.initializers.normal(stddev)``: a unit normal times
    float32(stddev)."""
    return prng.normal(key, shape, device=device).mul_(float(_f32(stddev)))


def embed_normal(key: prng.Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """Flax ``nn.Embed``'s default, ``variance_scaling(1, "fan_in",
    "normal", out_axis=0)`` over a ``[vocab, features]`` table: a unit
    normal times ``√(1/features)``."""
    fan_in, _ = compute_fans(shape, out_axis=0)
    return prng.normal(key, shape, device=device).mul_(float(np.sqrt(_f32(1.0 / fan_in))))


def dense_general_kernel(key: prng.Key, shape: Sequence[int], n_in: int = 1, device=None) -> torch.Tensor:
    """Flax ``nn.DenseGeneral``'s kernel over ``n_in`` input axes (``nn.Dense``
    is ``n_in = 1`` on a 2-D shape): :func:`lecun_normal` drawn on the
    flattened ``[prod(shape[:n_in]), prod(shape[n_in:])]`` shape, so its
    fans are the flat ones, then reshaped (flax ``linear.py``'s
    ``kernel_init_wrap``)."""
    flat = (math.prod(shape[:n_in]), math.prod(shape[n_in:]))
    return lecun_normal(key, flat, device).reshape(tuple(shape))
