"""The receive side of the wire: ``recv_into`` reads, the receive-buffer
ring, scatter-gather sends (the port of :mod:`dpwa_tpu.parallel.ingest`).

- :func:`recv_exact_into` is the one read loop: it fills a caller's buffer
  with ``sock.recv_into`` under a cumulative deadline that grows with the
  bytes received, as the reference's does (same exceptions, so the fetch's
  outcome classes are the same).
- :class:`BufferRing` hands out size-classed receive buffers
  (:class:`Lease`).  A ring made with ``pinned=True`` holds page-locked
  host memory, so that a frame that landed in it crosses to the card by an
  asynchronous copy: the TCP transport's rings on the card are pinned.  A
  lease goes back to the ring only when nothing reads its bytes any more;
  with a copy to the card in flight, that is after the copy's event.
- :func:`sendall_segments` sends ``[header, payload]`` with one
  ``sendmsg`` and finishes partial sends without joining the segments.

The ring keeps its own counts (hits, misses, the bytes leased); the
process-wide tally of frames and payload copies (:func:`note_rx_frame`,
:func:`rx_stats`) is the reference's ``copies_per_frame`` column.
"""

from __future__ import annotations

import errno
import socket
import threading
import time
import weakref
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

Buffer = Union[bytearray, memoryview]

_MIN_CLASS = 4096  # smallest size class
_MAX_FREE_PER_CLASS = 4  # free buffers kept per class
# A lease starts on a 64-byte boundary, so a dense payload at offset 0 is
# aligned for any vector load and for the card's copy engines.
LEASE_ALIGN = 64


def recv_exact_into(
    sock: socket.socket,
    n: int,
    deadline: Optional[float] = None,
    per_byte_s: float = 0.0,
    progress: Optional[list] = None,
    out: Optional[Buffer] = None,
) -> memoryview:
    """Read exactly ``n`` bytes into ``out`` (allocated if None) and return
    a writable memoryview of them.

    ``deadline`` (a ``time.monotonic`` instant) bounds the WHOLE read,
    extended by ``per_byte_s`` for every byte actually received; when it
    lapses this raises ``socket.timeout``.  ``progress`` (a one-cell list)
    counts the bytes received across reads and survives that timeout, so
    the caller can tell a slow peer from a silent one.  EOF before ``n``
    bytes raises ``ConnectionError``."""
    if out is None:
        out = bytearray(n)
    view = memoryview(out)[:n]
    filled = 0
    while filled < n:
        if deadline is not None:
            remaining = deadline + filled * per_byte_s - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("cumulative fetch deadline exceeded")
            sock.settimeout(remaining)
        cap = min(1 << 20, n - filled)
        got = sock.recv_into(view[filled : filled + cap])
        if not got:
            raise ConnectionError("peer closed mid-message")
        filled += got
        if progress is not None:
            progress[0] += got
    return view


class Lease:
    """One checked-out ring buffer: ``view`` is exactly the requested bytes.
    :meth:`release` hands it back once nothing reads them any more."""

    __slots__ = ("_ring", "_buf", "view", "_done")

    def __init__(self, ring: "BufferRing", buf: np.ndarray, n: int) -> None:
        self._ring = ring
        self._buf = buf
        off = (-buf.ctypes.data) % LEASE_ALIGN
        self.view = memoryview(buf)[off:off + n]
        self._done = False

    def release(self) -> None:
        """Return the buffer to the ring.  Idempotent.  Raises
        ``BufferError`` while an array still views the bytes."""
        if self._done:
            return
        self.view.release()
        self._done = True
        self._ring._put(self._buf)

    def recycle(self, owner: object) -> None:
        """Hand the bytes to ``owner`` (an array that every view of them
        keeps alive) and return the buffer to the ring when ``owner`` is
        collected.  Idempotent."""
        if self._done:
            return
        self._done = True
        weakref.finalize(owner, self._ring._put, self._buf)


class BufferRing:
    """Size-classed pool of receive buffers (powers of two from 4 KiB),
    each with ``LEASE_ALIGN`` bytes of slack so a lease starts aligned.
    ``pinned`` buffers are page-locked host memory (needs a CUDA build of
    torch with a card)."""

    def __init__(self, pinned: bool = False) -> None:
        self.pinned = bool(pinned)
        self._lock = threading.Lock()
        self._free: dict = {}  # class size -> [buffer, ...]
        self._leased_bytes = 0
        self._hits = 0
        self._misses = 0

    @staticmethod
    def _class_for(n: int) -> int:
        size = _MIN_CLASS
        while size < n:
            size <<= 1
        return size

    def _allocate(self, size: int) -> np.ndarray:
        t = torch.empty(size + LEASE_ALIGN, dtype=torch.uint8, pin_memory=self.pinned)
        return t.numpy()  # the array keeps the (pinned) storage alive

    def lease(self, n: int) -> Lease:
        if n < 0:
            raise ValueError(f"cannot lease {n} bytes")
        size = self._class_for(max(n, 1))
        with self._lock:
            pool = self._free.get(size)
            buf = pool.pop() if pool else None
            if buf is None:
                self._misses += 1
            else:
                self._hits += 1
            self._leased_bytes += size
        if buf is None:
            buf = self._allocate(size)
        return Lease(self, buf, n)

    def _put(self, buf: np.ndarray) -> None:
        size = buf.size - LEASE_ALIGN
        with self._lock:
            self._leased_bytes -= size
            pool = self._free.setdefault(size, [])
            if len(pool) < _MAX_FREE_PER_CLASS:
                pool.append(buf)

    def stats(self) -> dict:
        with self._lock:
            pooled = sum(b.size - LEASE_ALIGN for p in self._free.values() for b in p)
            leased = self._leased_bytes
            total = leased + pooled
            return {
                "pinned": self.pinned,
                "leased_bytes": leased,
                "pooled_bytes": pooled,
                "occupancy": (leased / total) if total else 0.0,
                "hits": self._hits,
                "misses": self._misses,
            }


_RX_LOCK = threading.Lock()
_RX = {"frames": 0, "copies": 0}


def note_rx_frame(copies: int) -> None:
    """Record one decoded frame and how many payload-sized copies its
    decode made (0: the payload was used where it landed)."""
    with _RX_LOCK:
        _RX["frames"] += 1
        _RX["copies"] += max(int(copies), 0)


def rx_stats() -> dict:
    """Frames decoded in this process and their mean payload copies."""
    with _RX_LOCK:
        frames, copies = _RX["frames"], _RX["copies"]
    return {
        "frames": frames,
        "copies": copies,
        "copies_per_frame": (copies / frames) if frames else 0.0,
    }


def reset_rx_stats() -> None:
    with _RX_LOCK:
        _RX["frames"] = _RX["copies"] = 0


# errnos with which some platforms refuse sendmsg on a TCP socket.
_SENDMSG_UNSUPPORTED = {
    getattr(errno, "ENOTSUP", None),
    getattr(errno, "EOPNOTSUPP", None),
    getattr(errno, "ENOSYS", None),
} - {None}


def sendall_segments(sock: socket.socket, segments: Sequence) -> None:
    """Send every segment, in order, without concatenating them: one
    ``sendmsg`` at a time, a partly sent head sliced, never copied; per
    segment ``sendall`` where ``sendmsg`` is missing or refused."""
    segs: List[memoryview] = [memoryview(s).cast("B") for s in segments if len(s)]
    if not segs:
        return
    sendmsg = getattr(sock, "sendmsg", None)
    if sendmsg is None:
        for seg in segs:
            sock.sendall(seg)
        return
    while segs:
        try:
            sent = sendmsg(segs)
        except OSError as exc:
            if exc.errno in _SENDMSG_UNSUPPORTED:
                for seg in segs:
                    sock.sendall(seg)
                return
            raise
        while sent > 0 and segs:
            head = segs[0]
            if sent >= len(head):
                sent -= len(head)
                segs.pop(0)
            else:
                segs[0] = head[sent:]
                sent = 0
