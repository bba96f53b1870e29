"""Sharded gossip payloads: 1/k of the replica per exchange (the port of
:mod:`dpwa_tpu.ops.shard`).

``shard: {k: >1}`` cuts the flat replica into ``k`` contiguous shards and
each publish carries the one that
:func:`~dpwa_tpu_torch.parallel.schedules.shard_draw` assigns to its clock.
On the wire it is payload code 6: the ``SHARD_HDR`` preamble (``shard_idx |
k | d | inner_code``), then the slice in one of the flat encodings or
codecs (:data:`_INNER_CODES`); top-k selects within the shard and the int8
scale tables restart at the slice.

Decode returns a :class:`ShardPayload`: only the receiver holds the replica
the slice splices into, and the merge touches only ``[lo, hi)``, leaving
the other k−1 slices bit-identical (an f32 lerp of a coordinate with itself
is not exact).  Decoding runs on the host, on the bytes as they arrived.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from dpwa_tpu_torch.ops.quantize import (
    Int8Payload,
    TopkPayload,
    _as_bytes,
    decode_int8_payload,
    decode_topk_payload,
)
from dpwa_tpu_torch.parallel import protocol_constants as pc

_HDR = pc.SHARD_HDR

# The encodings a shard body may carry; a nested shard (code 6 in code 6),
# f64 and u16 are malformed.
_INNER_CODES = (
    pc.PAYLOAD_F32,
    pc.PAYLOAD_BF16,
    pc.PAYLOAD_INT8_CHUNKED,
    pc.PAYLOAD_TOPK_DELTA,
)
# The trust plane's and wire_snapshot()'s names of the inner encodings.
INNER_NAMES = {pc.PAYLOAD_F32: "f32", pc.PAYLOAD_BF16: "bf16", pc.PAYLOAD_INT8_CHUNKED: "int8"}


def shard_bounds(d: int, k: int, idx: int) -> Tuple[int, int]:
    """``[lo, hi)`` of shard ``idx`` of a k-way partition of ``d``: the
    first ``d % k`` shards carry one extra element."""
    d, k, idx = int(d), int(k), int(idx)
    if k < 1:
        raise ValueError(f"shard count k must be >= 1, got {k}")
    if not 0 <= idx < k:
        raise ValueError(f"shard_idx {idx} out of range for k={k}")
    base, rem = divmod(d, k)
    lo = idx * base + min(idx, rem)
    return lo, lo + base + (1 if idx < rem else 0)


Inner = Union[torch.Tensor, Int8Payload, TopkPayload]


class ShardPayload:
    """A decoded shard frame: one contiguous slice of a d-element replica.
    ``inner`` is the slice's decoded content: a dense inner's bytes (uint8,
    :meth:`dense_inner` types them: float32, or bf16 as it arrived), an
    :class:`Int8Payload`, or a :class:`TopkPayload` over the slice.  ``nbytes`` is the body's size,
    preamble included."""

    __slots__ = ("d", "k", "shard_idx", "inner_code", "inner", "nbytes", "__weakref__")

    def __init__(self, d: int, k: int, shard_idx: int, inner_code: int, inner: Inner,
                 nbytes: int = 0):
        self.d = int(d)
        self.k = int(k)
        self.shard_idx = int(shard_idx)
        self.inner_code = int(inner_code)
        self.inner = inner
        self.nbytes = int(nbytes)

    @property
    def bounds(self) -> Tuple[int, int]:
        return shard_bounds(self.d, self.k, self.shard_idx)

    def to(self, device) -> "ShardPayload":
        """The payload with its inner content landed on ``device`` (a dense
        inner's bytes as they arrived, viewed as its type there)."""
        inner = self.inner
        if isinstance(inner, torch.Tensor):
            from dpwa_tpu_torch.device.handoff import to_device

            inner, event = to_device(inner, device)
            if event is not None:
                event.synchronize()
        else:
            inner = inner.to(device)
        return ShardPayload(self.d, self.k, self.shard_idx, self.inner_code, inner, self.nbytes)

    def dense_inner(self) -> torch.Tensor:
        """A dense inner as float32 or bf16 values (a view of its bytes,
        or a copy where they sit at an odd offset of the frame)."""
        inner = self.inner
        if inner.dtype != torch.uint8:
            return inner
        if inner.data_ptr() % 4:
            inner = inner.clone()
        if self.inner_code == pc.PAYLOAD_F32:
            return inner.view(torch.float32)
        return inner.view(torch.int16).view(torch.bfloat16)

    def slice_estimate(self, local_slice: torch.Tensor) -> torch.Tensor:
        """The sender's slice as float32: a dense inner widened (bf16 to
        float32 is exact) or dequantised; a top-k inner spliced into the
        receiver's own slice."""
        inner = self.inner
        if isinstance(inner, TopkPayload):
            return inner.densify(local_slice)
        if isinstance(inner, Int8Payload):
            return inner.dequantize()
        return self.dense_inner().to(torch.float32)

    def densify(self, local: torch.Tensor) -> torch.Tensor:
        """The full-vector estimate: ``local`` with the slice replaced (for
        the guard and the trust plumbing; the merge slices, never this)."""
        local = local.reshape(-1)
        if local.numel() != self.d:
            raise ValueError(
                f"shard payload is for d={self.d} but local replica has {local.numel()} elements"
            )
        lo, hi = self.bounds
        out = local.clone()
        out[lo:hi] = self.slice_estimate(local[lo:hi])
        return out


def encode_shard_payload(inner_payload: torch.Tensor, d: int, k: int, shard_idx: int,
                         inner_code: int) -> torch.Tensor:
    """The encoded slice (a uint8 tensor, on any device) → the code-6 body,
    on the same device."""
    if inner_code not in _INNER_CODES:
        raise ValueError(f"shard inner_code {inner_code} not shippable")
    shard_bounds(d, k, shard_idx)  # validates k and shard_idx
    head = torch.frombuffer(bytearray(_HDR.pack(int(shard_idx), int(k), int(d), int(inner_code))),
                            dtype=torch.uint8)
    body = inner_payload.reshape(-1).view(torch.uint8)
    return torch.cat([head.to(body.device), body])


def decode_shard_payload(buf) -> ShardPayload:
    """A host code-6 body → :class:`ShardPayload`; ValueError on anything
    malformed: a short preamble, k of 0, shard_idx out of range, k > d, a
    body whose length contradicts ``(d, k, shard_idx)``, an unknown or
    nested inner code, or an inner body its own codec rejects.  ``d``
    against the local replica is the transport's check."""
    raw = _as_bytes(buf)
    if raw.size < _HDR.size:
        raise ValueError("shard wire payload shorter than its preamble")
    shard_idx, k, d, inner_code = _HDR.unpack_from(raw, 0)
    if k < 1:
        raise ValueError(f"shard wire payload with k={k}")
    if shard_idx >= k:
        raise ValueError(f"shard wire payload shard_idx={shard_idx} out of range for k={k}")
    if d < 1 or k > d:
        raise ValueError(f"shard wire payload claims k={k} > d={d}")
    lo, hi = shard_bounds(d, k, shard_idx)
    m = hi - lo
    body = raw[_HDR.size:]
    if inner_code in (pc.PAYLOAD_F32, pc.PAYLOAD_BF16):
        width = 4 if inner_code == pc.PAYLOAD_F32 else 2
        if body.size != width * m:
            raise ValueError(
                f"shard body is {body.size} bytes; {width * m} expected for slice length {m}"
            )
        # The bytes as they arrived (a view), typed once they have landed.
        inner: Inner = torch.from_numpy(body)
    elif inner_code == pc.PAYLOAD_INT8_CHUNKED:
        inner = decode_int8_payload(body)
        if inner.n != m:
            raise ValueError(
                f"shard int8 body decodes {inner.n} elements; {m} expected for slice length {m}"
            )
    elif inner_code == pc.PAYLOAD_TOPK_DELTA:
        inner = decode_topk_payload(body)
        if inner.n != m:
            raise ValueError(f"shard top-k body is for n={inner.n}; slice length is {m}")
    else:
        raise ValueError(f"shard wire payload with inner_code={inner_code}")
    return ShardPayload(d, k, shard_idx, inner_code, inner, nbytes=raw.size)
