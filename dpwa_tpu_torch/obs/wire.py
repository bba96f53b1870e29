"""The ``DPWT`` trailer: a trace ID and a replica sketch on gossip frames
(the port of :mod:`dpwa_tpu.obs.wire`, byte for byte).

An optional section after the payload of a served frame, after the
membership digest, never counted in the header's ``nbytes``, and read
tolerantly: a reader that predates it sees nothing, and one that expects it
gets None on a truncation, a wrong magic or version, an absurd sketch
length or a non-finite value.  A malformed trailer degrades observability,
never an exchange.

Layout (little-endian)::

    DPWT | u8 version | u16 origin | u32 seq | f32 norm_est | u16 n
    n x f32 sketch values

``seq`` is the publisher's publish clock truncated to 32 bits and
``"{origin}:{seq}"`` the trace ID that joins the server's spans of this
frame to the fetcher's round record.  ``norm_est`` is the sketch's own L2
norm (zero without a sketch); ``n`` is zero when only tracing is on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from dpwa_tpu_torch.parallel import protocol_constants as pc

OBS_MAGIC = pc.OBS_MAGIC
OBS_VERSION = pc.OBS_VERSION
OBS_HEADER_SIZE = pc.OBS_HDR.size
MAX_SKETCH_VALUES = pc.MAX_SKETCH_VALUES


def header_sketch_count(header: bytes) -> Optional[int]:
    """The sketch-value count ``header`` declares, or None when it is not a
    valid DPWT header (its size, magic, version or an absurd count)."""
    if len(header) != OBS_HEADER_SIZE:
        return None
    magic, version, _origin, _seq, _norm, n = pc.OBS_HDR.unpack(header)
    if magic != OBS_MAGIC or version != OBS_VERSION or n > MAX_SKETCH_VALUES:
        return None
    return n


def values_size(n: int) -> int:
    """The bytes of ``n`` sketch values on the wire."""
    return 4 * n


@dataclasses.dataclass(frozen=True)
class ObsFrame:
    """A decoded DPWT section."""

    origin: int
    seq: int
    norm_est: float
    sketch: Optional[np.ndarray]  # float32 (n,), None when n == 0

    @property
    def trace_id(self) -> str:
        return f"{self.origin}:{self.seq}"


def encode_obs(origin: int, seq: int, norm_est: float = 0.0,
               sketch: Optional[np.ndarray] = None) -> bytes:
    if sketch is None:
        vals, n = b"", 0
    else:
        s = np.ascontiguousarray(sketch, dtype="<f4").reshape(-1)
        if s.size > MAX_SKETCH_VALUES:
            raise ValueError(f"sketch too large: {s.size}")
        vals, n = s.tobytes(), s.size
    head = pc.OBS_HDR.pack(OBS_MAGIC, OBS_VERSION, int(origin) & 0xFFFF,
                           int(seq) & 0xFFFFFFFF, float(norm_est), n)
    return head + vals


def decode_obs(blob: bytes) -> Optional[ObsFrame]:
    """Tolerant decode: None on any malformation."""
    if len(blob) < OBS_HEADER_SIZE:
        return None
    n = header_sketch_count(blob[:OBS_HEADER_SIZE])
    if n is None or len(blob) != OBS_HEADER_SIZE + values_size(n):
        return None
    _magic, _version, origin, seq, norm, n = pc.OBS_HDR.unpack(blob[:OBS_HEADER_SIZE])
    sketch = None
    if n:
        sketch = np.frombuffer(blob, dtype="<f4", count=n, offset=OBS_HEADER_SIZE).astype(
            np.float32)
        if not np.all(np.isfinite(sketch)):
            return None
    return ObsFrame(origin=origin, seq=seq, norm_est=float(norm), sketch=sketch)
