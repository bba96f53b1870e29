"""int8 stochastic-rounding wire emulation (the port of the JAX path of
:mod:`dpwa_tpu.ops.quantize`).

``protocol.wire_dtype: int8`` ships one byte per element plus one float32
scale per :data:`CHUNK` elements; the local replica and every merge stay
float32.  Each leaf is padded on its own to whole chunks; a chunk's scale
is its largest magnitude over 127, and an element is rounded
stochastically, ``q = clip(floor(v / scale + u), -127, 127)`` with ``u``
uniform in [0, 1) from the threefry key of (step, sender, leaf), so the
quantizer is unbiased.  The stacked exchange merges with what would have
arrived over the wire, ``q · scale`` (:func:`fake_quant_rows`).

Everything is the reference's compiled program bit for bit
(``tests/test_torch_quantize.py``):

- the uniform draws are ``jax.random.uniform``'s
  (:mod:`dpwa_tpu_torch.utils.prng`);
- the scale is ``max|chunk| · float32(1/127)``: XLA's simplifier turns the
  reference's division by the constant 127 into that product when the
  function is compiled, as every caller of the reference compiles it (an
  op-by-op call divides, and differs in the last bit of some scales);
- ``v / scale`` is an IEEE float32 division and ``floor`` a float32 floor,
  never a reciprocal product: the divisor is a tensor, so PyTorch does not
  turn it into one on the card;
- a chunk holding an inf has scale inf, so ``v / scale`` is NaN at the inf
  and 0 elsewhere; XLA casts the NaN to int8 0, and :func:`_codes` says so
  with an explicit ``where`` (a float-to-int cast of NaN is undefined in
  C++ and CUDA).  The chunk then dequantizes to NaN (``0 · inf``), and a
  chunk with a NaN to NaN through its NaN scale.

The numpy/Philox codec of the TCP transport (``quantize_np`` and the
rest) waits for the TCP port.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from dpwa_tpu_torch.utils import prng

CHUNK = 256  # float32 scale per 256 int8 elements
# Domain separation from the participation and fault streams, which fold
# other data into the same schedule seed.
_WIRE_SALT = 0x51A7
_INV_127 = float(np.float32(1.0) / np.float32(127.0))  # 0.00787401572
_MASK = 0xFFFFFFFF


def n_chunks(n: int) -> int:
    """Chunks of a leaf of ``n`` elements (at least one, as shipped)."""
    return max(1, math.ceil(n / CHUNK))


def wire_key(seed: int, step: int, sender: int, leaf: int = 0) -> prng.Key:
    """The threefry key of (step, sender, leaf)'s rounding draws: ``key(seed
    ^ 0x51A7)`` with step, sender and leaf folded in, in that order."""
    k = prng.key(int(seed) ^ _WIRE_SALT)
    return prng.fold_in(prng.fold_in(prng.fold_in(k, step), sender), leaf)


def _codes(chunks: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scales) of float32 ``[..., CHUNK]`` chunks with
    their uniform draws ``u`` (same shape)."""
    scale = chunks.abs().amax(dim=-1) * _INV_127
    live = scale > 0
    safe = torch.where(live, scale, torch.ones_like(scale))
    q = torch.floor(chunks / safe.unsqueeze(-1) + u).clamp_(-127.0, 127.0)
    q = torch.where(q.isnan() | ~live.unsqueeze(-1), torch.zeros_like(q), q)
    return q.to(torch.int8), scale


def quantize(v: torch.Tensor, key: prng.Key) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 tensor (any shape) → (int8 ``[K, CHUNK]``, float32 scales
    ``[K]``), the leaf zero-padded to ``K`` whole chunks."""
    flat = v.reshape(-1)
    k = n_chunks(flat.numel())
    chunks = torch.nn.functional.pad(flat, (0, k * CHUNK - flat.numel())).view(k, CHUNK)
    return _codes(chunks, prng.uniform(key, (k, CHUNK), device=v.device))


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """(int8 ``[K, CHUNK]``, float32 ``[K]``) → float32 tensor of ``shape``."""
    flat = (q.to(torch.float32) * scale.unsqueeze(-1)).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def fake_quant_wire(v: torch.Tensor, seed: int, step: int, sender: int, leaf: int = 0) -> torch.Tensor:
    """``v`` quantized and dequantized exactly as the wire would ship it."""
    q, scale = quantize(v, wire_key(seed, step, sender, leaf))
    return dequantize(q, scale, tuple(v.shape))


def fake_quant_tree(
    params: Mapping[str, torch.Tensor], seed: int, step: int, sender: int
) -> Dict[str, torch.Tensor]:
    """:func:`fake_quant_wire` on every float32 leaf of ``{name: tensor}``
    (given in the reference's leaf order), with the leaf's index in that
    order folded into its key; other leaves pass as they are."""
    return {
        name: fake_quant_wire(v, seed, step, sender, leaf=i) if v.dtype == torch.float32 else v
        for i, (name, v) in enumerate(params.items())
    }


def leaf_columns(leaf: Sequence) -> np.ndarray:
    """The buffer columns of one shipped leaf, in the reference's element
    order: ``(lo, hi)`` for a leaf the buffer lays out as the reference
    does; ``(lo, hi, shape, axes)`` for one stored in ``shape`` whose
    reference layout is its ``permute(axes)`` (a conv kernel kept OIHW,
    shipped in the reference's HWIO order)."""
    cols = np.arange(int(leaf[0]), int(leaf[1]), dtype=np.int64)
    if len(leaf) == 4:
        cols = cols.reshape(leaf[2]).transpose(leaf[3]).ravel()
    return cols


class WirePlan:
    """Where the int8 wire's chunks of a row lie in a flat ``[n, ld]``
    buffer, for :func:`fake_quant_rows`.

    ``leaves`` are the shipped leaves (:func:`leaf_columns`: column ranges
    ``[lo, hi)``, or ranges with the leaf's stored shape and its axis order
    to the reference's layout) in the order whose index keys each leaf's
    draws (the reference's flatten order of the exchanged tree).  Each
    leaf's elements fill its chunks in the reference's element order, and
    each leaf is padded to whole chunks.
    Per element of the padded chunk stream the plan holds its column (0 for
    padding, masked by ``valid``), its leaf and its counter within the
    leaf's draws; and, for the write back, the stream positions of the
    real elements with their columns, whose block bounds it finds on the
    host, so a step never waits on the card."""

    def __init__(self, leaves: Sequence[tuple], device):
        self.leaves = [tuple(leaf) for leaf in leaves]
        widths = [n_chunks(leaf[1] - leaf[0]) * CHUNK for leaf in self.leaves]
        if any(w > _MASK for w in widths):
            raise ValueError("a leaf of 2^32 elements or more does not fit the draws' counter")
        cols = np.zeros(sum(widths), np.int64)
        valid = np.zeros(sum(widths), bool)
        leaf_of = np.repeat(np.arange(len(widths), dtype=np.int64), widths)
        counter = np.concatenate([np.arange(w, dtype=np.int64) for w in widths] or [cols])
        start = 0
        for leaf, width in zip(self.leaves, widths):
            size = leaf[1] - leaf[0]
            cols[start:start + size] = leaf_columns(leaf)
            valid[start:start + size] = True
            start += width
        self.n_leaves = len(self.leaves)
        self.n_chunks = cols.size // CHUNK
        self.positions = np.flatnonzero(valid)  # host copy, for the block bounds
        as_dev = lambda a: torch.as_tensor(a, device=device)
        self.cols, self.valid = as_dev(cols), as_dev(valid)
        self.leaf_of, self.counter = as_dev(leaf_of), as_dev(counter)
        self.real_pos, self.real_cols = as_dev(self.positions), as_dev(cols[self.positions])

    def real(self, e0: int, e1: int) -> slice:
        """The entries of ``real_pos`` / ``real_cols`` in stream block
        ``[e0, e1)``."""
        return slice(*np.searchsorted(self.positions, [e0, e1]).tolist())


def _leaf_keys(seed: int, step: int, senders: torch.Tensor, n_leaves: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two words of :func:`wire_key` for every (sender, leaf), as int64
    ``[len(senders), n_leaves]`` tensors: the step folded in on the host,
    sender and leaf on the tensors' device."""
    k = prng.fold_in(prng.key(int(seed) ^ _WIRE_SALT), step)
    s0, s1 = prng.threefry_words(k, torch.zeros_like(senders), senders.clone())
    rows, dev = senders.numel(), senders.device
    leaf = torch.arange(n_leaves, dtype=torch.int64, device=dev).expand(rows, n_leaves).clone()
    return prng.threefry_words(
        (s0[:, None], s1[:, None]), torch.zeros_like(leaf), leaf
    )


def fake_quant_rows(
    x: torch.Tensor, w: torch.Tensor, plan: WirePlan, seed: int, step: int,
    max_elements: int = prng.CHUNK,
) -> torch.Tensor:
    """Row ``s`` of ``x`` (``[n, ld]`` float32, row ``s`` sender ``s``'s
    replica) quantized and dequantized as sender ``s`` ships it, leaf by
    leaf, into the same columns of ``w`` (``[n, ld]``; other columns are
    not written).  Bit-equal to :func:`fake_quant_tree` on each row's
    leaves, with the leaf index their place in ``plan.leaves``.  Works in
    blocks of rows and chunks of at most ``max_elements`` draws.
    Returns ``w``."""
    n = x.shape[0]
    if plan.n_chunks == 0 or n == 0:
        return w
    senders = torch.arange(n, dtype=torch.int64, device=x.device)
    k0, k1 = _leaf_keys(seed, step, senders, plan.n_leaves)
    per_row = plan.n_chunks * CHUNK
    step_chunks = max(1, min(plan.n_chunks, max_elements // CHUNK))
    rows_per_block = max(1, max_elements // per_row) if step_chunks == plan.n_chunks else 1
    for r0 in range(0, n, rows_per_block):
        r1 = min(n, r0 + rows_per_block)
        for c0 in range(0, plan.n_chunks, step_chunks):
            c1 = min(plan.n_chunks, c0 + step_chunks)
            e0, e1 = c0 * CHUNK, c1 * CHUNK
            vals = x[r0:r1].index_select(1, plan.cols[e0:e1])
            vals = torch.where(plan.valid[e0:e1], vals, torch.zeros_like(vals))
            leaf = plan.leaf_of[e0:e1]
            kb = (k0[r0:r1][:, leaf], k1[r0:r1][:, leaf])
            ctr = plan.counter[e0:e1].expand(r1 - r0, e1 - e0)
            bits = prng.threefry_words(kb, torch.zeros_like(ctr), ctr.clone())
            u = prng.unit_floats(bits[0].bitwise_xor_(bits[1]))
            q, scale = _codes(vals.view(r1 - r0, c1 - c0, CHUNK), u.view(r1 - r0, c1 - c0, CHUNK))
            deq = (q.to(torch.float32) * scale.unsqueeze(-1)).view(r1 - r0, e1 - e0)
            real = plan.real(e0, e1)
            w[r0:r1].index_copy_(
                1, plan.real_cols[real], deq.index_select(1, plan.real_pos[real] - e0)
            )
    return w
