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

The TCP transport's codecs (the reference's numpy path, as its native
library runs it) are at the end: the int8-chunked frame (payload code 4),
quantised on the card by :func:`quantize_sr` (``csrc/quantize.cu``), and
the top-k delta frame (code 5) with its error-feedback encoder.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# The TCP wire's codecs: the int8-chunked frame (payload code 4) and the
# top-k delta frame (code 5), byte for byte the reference's native path.
# ---------------------------------------------------------------------------
#
# int8-chunked body:  u64 n | f32 scales[ceil(n/CHUNK)] | int8 q[n]  (n = 0:
# one zero scale).  A chunk's scale is max|x| / 127 (a NaN skipped), and
# q = clamp(floor(x·inv + u), -127, 127), inv = 1/scale, with x·inv rounded
# and then u added in one more rounding (the reference's g++ fuses the
# dither's product ``b · 2^-24`` with the sum, which is exact, and not
# ``x · inv``); the dither u of element i is the 24-bit slice (low for even
# i, bits 24-47 for odd i) of splitmix64(key + (i >> 1)), key = mix64(k0) ^
# (k1 · 0xD1B54A32D192ED03) from (seed ^ 0x51A7, sender) and the publish
# clock's float64 bits.
#
# top-k body:  u64 n | u32 k | u8 value_code | u32 idx[k] (increasing) |
# values: f32[k] (code 0) or the int8-chunked block of the k gathered values
# without its length, scales then codes (code 1).  Values are absolute
# coordinates; the receiver densifies against its own replica.

_TOPK_SALT = 0x70CC
TOPK_VALUE_F32 = 0
TOPK_VALUE_INT8 = 1
_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX_1, _MIX_2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
_KEY_MUL = 0xD1B54A32D192ED03


def _np_key_words(seed: int, clock: float, sender: int) -> Tuple[int, int]:
    """The two 64-bit key words of a publish: ``(seed ^ 0x51A7, sender)`` in
    one, the clock's float64 bit pattern in the other (fractional clocks
    get streams of their own)."""
    k0 = ((int(seed) ^ _WIRE_SALT) & _MASK) | ((int(sender) & _MASK) << 32)
    k1 = int(np.float64(clock).view(np.uint64))
    return k0, k1


def _mix64(x: int) -> int:
    x = (x + _GOLDEN) & _M64
    x = ((x ^ (x >> 30)) * _MIX_1) & _M64
    x = ((x ^ (x >> 27)) * _MIX_2) & _M64
    return x ^ (x >> 31)


def dither_key(k0: int, k1: int) -> int:
    """The 64-bit stream key of :func:`quantize_sr`."""
    return _mix64(k0 & _M64) ^ ((k1 * _KEY_MUL) & _M64)


def int8_nbytes(n: int) -> int:
    """Bytes of an int8-chunked body of ``n`` elements."""
    return 8 + 4 * n_chunks(n) + int(n)


# 64-bit words as (high, low) int64 tensors of 32-bit halves: sums and
# products that never leave int64's range (the plain twin of the kernel's
# uint64 arithmetic, on any device).
def _add64(h: torch.Tensor, l: torch.Tensor, c: int):
    l = l + (c & _MASK)
    h = (h + (c >> 32) + (l >> 32)) & _MASK
    return h, l & _MASK


def _xorshr64(h: torch.Tensor, l: torch.Tensor, s: int):
    return h ^ (h >> s), l ^ (((l >> s) | (h << (32 - s))) & _MASK)


def _mul_lo32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a · b) mod 2^32`` for a < 2^32, b < 2^32."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _MASK


def _mul64(h: torch.Tensor, l: torch.Tensor, c: int):
    """``(h:l) · c mod 2^64``."""
    ch, cl = c >> 32, c & _MASK
    p0, p1 = l * (cl & 0xFFFF), l * (cl >> 16)
    t = p0 + ((p1 & 0xFFFF) << 16)
    carry = (t >> 32) + (p1 >> 16)  # the high word of l · cl
    return (carry + _mul_lo32(l, ch) + _mul_lo32(h, cl)) & _MASK, t & _MASK


def _dither(key: int, i: torch.Tensor) -> torch.Tensor:
    """The float32 dither of elements ``i`` (int64) under ``key``."""
    pair = i >> 1
    h, l = _add64(torch.zeros_like(pair), pair, key)
    h, l = _add64(h, l, _GOLDEN)
    h, l = _mul64(*_xorshr64(h, l, 30), _MIX_1)
    h, l = _mul64(*_xorshr64(h, l, 27), _MIX_2)
    h, l = _xorshr64(h, l, 31)
    low = l & 0xFFFFFF
    high = ((l >> 24) | (h << 8)) & 0xFFFFFF
    bits = torch.where((i & 1) == 1, high, low)
    return bits.to(torch.float32) * (1.0 / 16777216.0)


def torch_quantize_sr(x: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """Plain version of :func:`quantize_sr`, in torch operations on ``x``'s
    device: the int8-chunked body of flat float32 ``x`` as uint8."""
    x = x.reshape(-1)
    n = x.numel()
    k = n_chunks(n)
    out = torch.empty(int8_nbytes(n), dtype=torch.uint8, device=x.device)
    out[:8] = torch.tensor(np.array([n], "<u8").view(np.uint8), device=x.device)
    if n == 0:
        out[8:12] = 0
        return out
    chunks = torch.nn.functional.pad(x, (0, k * CHUNK - n)).view(k, CHUNK)
    a = chunks.abs()
    m = torch.where(torch.isnan(a), torch.zeros_like(a), a).amax(dim=1)
    # IEEE divisions: a tensor divisor (PyTorch turns a division by a scalar
    # into a product with its reciprocal on the card).
    scale = m / torch.full_like(m, 127.0)
    inv = torch.ones_like(scale) / scale
    u = _dither(dither_key(k0, k1), torch.arange(k * CHUNK, dtype=torch.int64,
                                                device=x.device)).view(k, CHUNK)
    t = torch.floor(chunks * inv.unsqueeze(-1) + u).clamp_(-127.0, 127.0)
    dead = torch.isnan(t) | (scale == 0).unsqueeze(-1)
    q = torch.where(dead, torch.zeros_like(t), t).to(torch.int8)
    out[8:8 + 4 * k] = scale.view(torch.uint8)
    out[8 + 4 * k:] = q.view(-1)[:n].view(torch.uint8)
    return out


_VOID, _I64, _U64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64


@functools.cache
def _lib() -> ctypes.CDLL:
    """The quantiser's library, built and loaded at the first launch."""
    from dpwa_tpu_torch.ops import _build

    lib = _build.load("quantize.cu")
    lib.dpwa_quantize_sr.argtypes = [_VOID, _I64, _VOID, _U64, _VOID]
    lib.dpwa_quantize_sr.restype = ctypes.c_int
    lib.dpwa_quantize_error_string.argtypes = [ctypes.c_int]
    lib.dpwa_quantize_error_string.restype = ctypes.c_char_p
    return lib


def quantize_sr(x: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """The int8-chunked body (``u64 n | f32 scales | int8 q``) of the flat
    float32 vector ``x`` with the dither of key words ``(k0, k1)``, as a
    uint8 tensor on ``x``'s device: on the card one launch of
    ``csrc/quantize.cu`` writes all of it, so one readback publishes the
    frame; on the CPU the plain version :func:`torch_quantize_sr`."""
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_sr: x must be float32, got {x.dtype}")
    x = x.reshape(-1)
    if x.device.type == "cpu":
        return torch_quantize_sr(x, k0, k1)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_sr: unsupported device {x.device}")
    x = x.contiguous()
    n = x.numel()
    if n == 0:
        return torch_quantize_sr(x, k0, k1)
    out = torch.empty(int8_nbytes(n), dtype=torch.uint8, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dpwa_quantize_sr(
            x.data_ptr(), n, out.data_ptr(), dither_key(k0, k1),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        msg = lib.dpwa_quantize_error_string(err).decode()
        raise RuntimeError(f"quantize_sr kernel launch failed: {msg} ({err})")
    quantize_sr.launches += 1
    return out


quantize_sr.launches = 0


def encode_int8_payload(vec: torch.Tensor, seed: int, clock: float, sender: int) -> torch.Tensor:
    """The code-4 body of ``vec`` as published at ``clock`` by ``sender``
    (uint8, on ``vec``'s device)."""
    return quantize_sr(vec.to(torch.float32), *_np_key_words(seed, clock, sender))


def _as_bytes(buf) -> np.ndarray:
    """A host body (numpy array, bytes or CPU tensor) as a flat uint8 array,
    without a copy where it can be viewed."""
    if isinstance(buf, torch.Tensor):
        buf = buf.numpy()
    return np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray, memoryview)) \
        else np.ascontiguousarray(buf, dtype=np.uint8).reshape(-1)


def _int8_layout(raw: np.ndarray) -> Tuple[int, int]:
    """``(n, chunks)`` of a host int8-chunked body, validated as the
    reference validates it (ValueError when malformed)."""
    if raw.size < 8:
        raise ValueError("int8 wire payload shorter than its length field")
    n = int(raw[:8].view("<u8")[0])
    k = n_chunks(n)
    if raw.size != 8 + 4 * k + n:
        raise ValueError(
            f"int8 wire payload size {raw.size} != {8 + 4 * k + n} expected for n={n}"
        )
    return n, k


class Int8Payload:
    """A decoded code-4 body: ``n`` elements, the body's bytes (a uint8
    tensor, on the host as it arrived or on the card once landed) and its
    size on the wire.  The scales and codes are views of the body."""

    __slots__ = ("n", "body", "nbytes", "__weakref__")

    def __init__(self, n: int, body: torch.Tensor):
        self.n = int(n)
        self.body = body
        self.nbytes = int(body.numel())

    def views(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(scales, q)``: float32 ``[chunks]`` and int8 ``[n]`` views."""
        k = n_chunks(self.n)
        body = self.body
        if body.data_ptr() % 4:  # a host body at an odd offset: one copy
            body = body.clone()
        return body[8:8 + 4 * k].view(torch.float32), body[8 + 4 * k:].view(torch.int8)

    def to(self, device) -> "Int8Payload":
        from dpwa_tpu_torch.device.handoff import to_device

        body, event = to_device(self.body, device)
        if event is not None:
            event.synchronize()
        return Int8Payload(self.n, body)

    def dequantize(self) -> torch.Tensor:
        """The float32 vector the body decodes to, where the body lies."""
        scales, q = self.views()
        return dequantize_flat(q, scales)


def dequantize_flat(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 ``[n]`` codes and their float32 chunk scales → float32 ``[n]``,
    ``float(q) · scale`` (the reference's native decode)."""
    n = q.numel()
    k = n_chunks(n)
    if n and scales.numel() != k:
        raise ValueError(f"scales has {scales.numel()} entries; {k} expected for n={n}")
    padded = torch.nn.functional.pad(q, (0, k * CHUNK - n))
    return dequantize(padded.view(k, CHUNK), scales, (n,))


def decode_int8_payload(buf) -> Int8Payload:
    """A host code-4 body → :class:`Int8Payload` viewing it (ValueError when
    malformed; the transport classifies that ``corrupt``)."""
    raw = _as_bytes(buf)
    n, _k = _int8_layout(raw)
    return Int8Payload(n, torch.from_numpy(raw))


def int8_payload_views(buf) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """``(n, scales, q)`` of a host code-4 body, validated as
    :func:`decode_int8_payload`, without dequantising."""
    payload = decode_int8_payload(buf)
    return (payload.n, *payload.views())


def topk_nbytes(n: int, k: int, value_dtype: str = "int8") -> int:
    """Bytes of a top-k body of ``k`` values of ``n`` (header, indices,
    values)."""
    k = max(1, min(int(k), int(n))) if n else 0
    vals = 4 * k if value_dtype == "f32" else 4 * n_chunks(k) + k
    return 13 + 4 * k + vals


def topk_k(n: int, fraction: float) -> int:
    """k for ``n`` coordinates at ``protocol.topk_fraction`` (Python's
    ``round``), clamped to [1, n]."""
    return max(1, min(int(n), int(round(float(fraction) * int(n)))))


def topk_select(delta: torch.Tensor, k: int, seed: int, clock: float, sender: int) -> torch.Tensor:
    """The k largest-|delta| coordinates, sorted ascending (int64, on
    ``delta``'s device).  The threshold is the k-th largest score; every
    score above it is taken, and the ``need`` still missing are drawn from
    the scores equal to it by the reference's tie-break: a Philox draw keyed
    on (seed ^ 0x70CC, clock, sender) per tied coordinate, then the index.
    Only the tied coordinates' indices come to the host."""
    n = delta.numel()
    k = max(1, min(int(k), n))
    if k == n:
        return torch.arange(n, dtype=torch.int64, device=delta.device)
    score = delta.abs()
    # np.argpartition's pick at n - k: the smallest of the k largest (on the
    # card torch.topk is a multi-block select; torch.kthvalue is one block).
    thresh = torch.topk(score, k, sorted=False).values.min()
    above = torch.nonzero(score > thresh).view(-1)
    need = k - above.numel()
    if need <= 0:
        idx = above[:k]
    else:
        at = torch.nonzero(score == thresh).view(-1).cpu().numpy()
        tie = np.random.Generator(
            np.random.Philox(key=list(_np_key_words(seed ^ _TOPK_SALT, clock, sender)))
        ).random(at.shape[0])
        chosen = at[np.lexsort((at, tie))[:need]]
        idx = torch.cat([above, torch.from_numpy(chosen).to(delta.device)])
    if idx.numel() != k:
        # A NaN score: no coordinate compares above or equal to it.  The
        # reference's encoder raises here too.
        raise ValueError(f"top-k selection found {idx.numel()} of {k} coordinates "
                         "(a non-finite delta)")
    return torch.sort(idx).values


class TopkPayload:
    """A decoded top-k frame: ``n`` coordinates, sorted ``indices`` (int64)
    and float32 ``values`` (absolute coordinates, dequantised when the value
    block was int8), which block arrived, and the body's size."""

    __slots__ = ("n", "indices", "values", "value_dtype", "nbytes", "__weakref__")

    def __init__(self, n, indices, values, value_dtype="f32", nbytes=0):
        self.n = int(n)
        self.indices = indices
        self.values = values
        self.value_dtype = value_dtype
        self.nbytes = int(nbytes)

    @property
    def k(self) -> int:
        return self.indices.numel()

    def to(self, device) -> "TopkPayload":
        from dpwa_tpu_torch.device.handoff import to_device

        idx, e1 = to_device(self.indices, device)
        vals, e2 = to_device(self.values, device)
        for event in (e1, e2):
            if event is not None:
                event.synchronize()
        return TopkPayload(self.n, idx, vals, self.value_dtype, self.nbytes)

    def densify(self, local: torch.Tensor) -> torch.Tensor:
        """The sender's estimate against the receiver's replica: ``local``
        with the shipped values at the indices (a new tensor)."""
        local = local.reshape(-1)
        if local.numel() != self.n:
            raise ValueError(
                f"top-k payload is for n={self.n} but local replica has {local.numel()} elements"
            )
        out = local.clone()
        out[self.indices] = self.values
        return out


class TopkEncoder:
    """The sender's error feedback for the top-k wire.  ``base`` (on the
    replica's device) is what the ring has been told of each coordinate:
    each publish scores ``|vec − base|``, ships the top k as absolute
    values, and sets ``base`` at the shipped indices to the values as they
    decode on the wire, so dropped movement and rounding stay in the score."""

    def __init__(self, fraction: float, value_dtype: str = "int8"):
        self.fraction = float(fraction)
        self.value_dtype = value_dtype
        self.base: Optional[torch.Tensor] = None

    def reset(self) -> None:
        self.base = None

    def encode(self, vec: torch.Tensor, seed: int, clock: float, sender: int) -> torch.Tensor:
        """float32 ``[n]`` → the code-5 body (uint8, on ``vec``'s device)."""
        flat = vec.reshape(-1).to(torch.float32)
        n = flat.numel()
        if self.base is None or self.base.numel() != n or self.base.device != flat.device:
            self.base = torch.zeros(n, dtype=torch.float32, device=flat.device)
        k = topk_k(n, self.fraction)
        idx = topk_select(flat - self.base, k, seed, clock, sender)
        vals = flat[idx]
        head = np.zeros(13, np.uint8)
        head[:8].view("<u8")[0] = n
        head[8:12].view("<u4")[0] = k
        if self.value_dtype == "int8":
            block = quantize_sr(vals, *_np_key_words(seed, clock, sender))[8:]
            kc = n_chunks(k)
            scales = block[:4 * kc].clone().view(torch.float32)
            shipped = dequantize_flat(block[4 * kc:].view(torch.int8), scales)
            head[12] = TOPK_VALUE_INT8
        else:
            block = vals.view(torch.uint8)
            shipped = vals
            head[12] = TOPK_VALUE_F32
        self.base[idx] = shipped
        return torch.cat([
            torch.from_numpy(head).to(flat.device),
            idx.to(torch.int32).view(torch.uint8),
            block,
        ])


def decode_topk_payload(buf) -> TopkPayload:
    """A host code-5 body → :class:`TopkPayload`; ValueError on anything
    malformed, in the reference's order: a short header, n or k of 0, k >
    n, an unknown value code, a length that disagrees, an index out of
    range, indices not strictly increasing."""
    raw = _as_bytes(buf)
    if raw.size < 13:
        raise ValueError("top-k wire payload shorter than its header")
    n = int(raw[:8].view("<u8")[0])
    k = int(raw[8:12].view("<u4")[0])
    code = int(raw[12])
    if n < 1 or k < 1:
        raise ValueError(f"top-k wire payload with n={n}, k={k}")
    if k > n:
        raise ValueError(f"top-k wire payload claims k={k} > n={n}")
    if code not in (TOPK_VALUE_F32, TOPK_VALUE_INT8):
        raise ValueError(f"top-k wire payload with value_code={code}")
    vals_nbytes = 4 * k if code == TOPK_VALUE_F32 else 4 * n_chunks(k) + k
    expect = 13 + 4 * k + vals_nbytes
    if raw.size != expect:
        raise ValueError(
            f"top-k wire payload size {raw.size} != {expect} expected for n={n}, k={k}, "
            f"value_code={code}"
        )
    idx = raw[13:13 + 4 * k].view("<u4")
    if int(idx[-1]) >= n:
        raise ValueError(f"top-k wire payload index {int(idx[-1])} out of range for n={n}")
    if k > 1 and not np.all(idx[1:] > idx[:-1]):
        raise ValueError("top-k wire payload indices not strictly increasing")
    body = raw[13 + 4 * k:]
    if code == TOPK_VALUE_F32:
        vals = torch.from_numpy(body.view("<f4").copy())
        vdtype = "f32"
    else:
        kc = n_chunks(k)
        vals = dequantize_flat(torch.from_numpy(body[4 * kc:].view(np.int8)),
                               torch.from_numpy(body[:4 * kc].view("<f4").copy()))
        vdtype = "int8"
    return TopkPayload(n, torch.from_numpy(idx.astype(np.int64)), vals, value_dtype=vdtype,
                       nbytes=raw.size)
