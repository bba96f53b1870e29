"""TCP gossip transport: one OS process per node (the port of
:mod:`dpwa_tpu.parallel.tcp`, its base protocol).

Every node runs an Rx thread (:class:`PeerServer`) that serves the node's
most recently published replica with its clock and loss; once a step the
training thread publishes, picks its partner from the schedule, draws
whether it takes part, fetches the partner's frame with a cumulative
deadline, guards it and merges.  A fetch that fails is skipped and
training goes on.

The frame is the reference's, byte for byte: ``BLOB_HDR`` (magic, version,
payload code, clock, loss, nbytes) and the flat little-endian payload,
float32 or bf16 (``protocol.wire_dtype``), rounded as the reference
rounds it, followed by the optional trailers: the sender's membership
digest (``DPWM``), which ``nbytes`` does not count.  A port node and a
``dpwa_tpu`` node gossip with each other; the fetcher reads the trailers
after the payload tolerantly, dispatching on their magics (an
observability section, ``DPWT``, is read past and dropped), and a peer
that serves none is the old wire, not a failure.  The RELAY verb asks a
node to header-probe a third on the asker's behalf (:func:`relay_probe`).

:meth:`TcpTransport.exchange_on_device` merges a replica that lives on the
card: the publish reads back only the wire's bytes and only once per merge
(:class:`~dpwa_tpu_torch.device.replica.DeviceReplica`), the frame lands in
a pinned receive buffer and crosses to the card by an asynchronous copy,
the guard runs there, and the merge is one launch of B2 over ``[1, d]``
(:func:`~dpwa_tpu_torch.device.engine.merge`).
:meth:`TcpTransport.exchange` is the same round for a host vector, merged
on the CPU by B2's plain version.

Four planes run around the round, as the reference runs them by default.
Health: every classified fetch outcome feeds a
:class:`~dpwa_tpu_torch.health.scoreboard.Scoreboard`, which quarantines a
failing partner; :meth:`TcpTransport._resolve_partner` spends a header-only
probe on it once its backoff has run out and otherwise remaps the round to
a threefry-drawn healthy fallback (with none left, a self-pair: a solo
round).  Recovery: the pre-merge guard, the STATE wire (a donor serves its
packed state in CRC-checked chunks, one per connection; the fetch resumes
after short reads) for a restarted node's bootstrap, and the re-sync
advice when a probed peer's clock leads by more than
``recovery.max_clock_lag``.  Membership: every published frame carries the
digest of this node's view, every fetched digest is merged into it, a
failure that would quarantine a peer first asks drawn healthy relays to
probe it (``indirect_probes``), and each round ends with the component,
quorum and heal bookkeeping (:class:`~dpwa_tpu_torch.membership.manager.
MembershipManager`), whose degraded mode scales α.  Trust: after the
guard, every fetched frame is screened against the local replica where it
lies (:mod:`dpwa_tpu_torch.trust`); a rejection is the ``untrusted``
outcome and a suspect's α is damped.  The guard's and the screen's scalars
come back to the host in one readback.

Ported: the threaded Rx server, the classified fetch (refused, timeout,
slow, busy, short_read, corrupt, poisoned, untrusted, success), every
schedule of the port with ``fetch_probability`` and ``drop_probability``,
the constant, clock and loss interpolations, recovery, health, membership
(its global view) and trust.  Not yet: the codecs (``wire_dtype: int8``,
``wire_codec: topk``, ``shard:``), the prefetch pipeline, the reactor and
native Rx servers, ``/healthz`` and the flowctl plane; the transport
raises :class:`NotImplementedError` for the settings that ask for them, and
warns once when the config leaves flowctl, a default-on plane of the
reference, on.
"""

from __future__ import annotations

import socket
import threading
import time
import warnings
import zlib
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from dpwa_tpu_torch.config import DEFAULT_MIN_WIRE_MB_PER_S, DpwaConfig
from dpwa_tpu_torch.device import engine
from dpwa_tpu_torch.device.handoff import to_device
from dpwa_tpu_torch.device.replica import DeviceReplica
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.health.scoreboard import Scoreboard
from dpwa_tpu_torch.health.scoreboard import PeerState
from dpwa_tpu_torch.interpolation import PeerMeta, make_interpolation
from dpwa_tpu_torch.membership import digest as _digest
from dpwa_tpu_torch.membership.manager import MembershipManager
from dpwa_tpu_torch.parallel import ingest
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel.schedules import Schedule, build_schedule, relay_draw
from dpwa_tpu_torch.recovery.guard import payload_check_tensors, validate_payload
from dpwa_tpu_torch.trust.manager import REJECTED, TrustManager
from dpwa_tpu_torch.trust.screen import payload_sums, stats_from_sums
from dpwa_tpu_torch.utils.devices import resolve_device

# Flat payload codes: the numpy dtype the bytes are read as, and the torch
# dtype of the decoded vector (bf16 read as int16 and viewed).
_FLAT = {
    pc.PAYLOAD_F32: (np.dtype("<f4"), torch.float32),
    pc.PAYLOAD_F64: (np.dtype("<f8"), torch.float64),
    pc.PAYLOAD_U16: (np.dtype("<u2"), torch.uint16),
    pc.PAYLOAD_BF16: (np.dtype("<i2"), torch.bfloat16),
}
_WIRE_CODES = {"f32": pc.PAYLOAD_F32, "bf16": pc.PAYLOAD_BF16}

# The payload read's deadline grows by one second per this many bytes
# received (protocol.min_wire_mb_per_s), so a large replica streaming from
# a live peer is never cut by a deadline sized for the rendezvous.
_MIN_WIRE_BANDWIDTH = DEFAULT_MIN_WIRE_MB_PER_S * 1e6
# An advertisement above this reads a probe's worth of bytes before the
# full buffer is leased: a peer that lies about nbytes costs 64 KiB.
_PROBE_THRESHOLD = 1 << 20
_PROBE_BYTES = 1 << 16
# The Rx server's budget for one connection.
_HANDLER_TIMEOUT_S = 5.0
# The fetcher's budget for the optional trailers after a payload: a peer
# that streamed the payload sends its ~11 B a peer of digest at once.
_TRAILER_BUDGET_S = 0.25

# The relay report's outcome byte indexes these; the names on the wire are
# protocol_constants' and must stay aligned with the Outcome strings.
_RELAY_OUTCOMES = (
    Outcome.SUCCESS, Outcome.TIMEOUT, Outcome.REFUSED,
    Outcome.SHORT_READ, Outcome.CORRUPT, Outcome.BUSY,
)
assert tuple(_RELAY_OUTCOMES) == pc.RELAY_OUTCOME_NAMES


def _frame_segments(
    payload: torch.Tensor, clock: float, loss: float, digest: Optional[bytes] = None
) -> tuple:
    """``(header, payload bytes[, digest])``: the wire frame as the segments
    the server sends, the payload a view of ``payload``'s host memory
    (which the caller must not change while it is served), then the
    membership digest trailer when there is one.  The code follows the
    payload's dtype: float32, float64 or bf16."""
    code = next(c for c, (_, dt) in _FLAT.items() if dt == payload.dtype)
    flat = payload.reshape(-1).contiguous()
    if flat.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    data = flat.numpy().view(np.uint8)
    header = pc.BLOB_HDR.pack(pc.BLOB_MAGIC, 1, code, float(clock), float(loss), data.size)
    return (header, data) if not digest else (header, data, bytes(digest))


def _frame(
    payload: torch.Tensor, clock: float, loss: float, digest: Optional[bytes] = None
) -> bytes:
    """:func:`_frame_segments` joined: the frame as one byte string."""
    return b"".join(bytes(s) for s in _frame_segments(payload, clock, loss, digest))


class _LazyState:
    """A state blob packed at its first request (then kept): a publish
    that no peer asks for costs nothing beyond holding what it reads."""

    __slots__ = ("_pack", "_blob", "_lock")

    def __init__(self, pack: Callable[[], bytes]):
        self._pack: Optional[Callable[[], bytes]] = pack
        self._blob: Optional[bytes] = None
        self._lock = threading.Lock()

    def get(self) -> bytes:
        with self._lock:
            if self._blob is None:
                self._blob = bytes(self._pack())
                self._pack = None
            return self._blob


class PeerServer:
    """The Rx thread: serves this node's latest published frame and state.

    One thread accepts; each connection gets a thread of its own with a
    bounded budget.  A blob request (a header probe too: it reads the
    header and hangs up) gets the frame with its digest trailer, or a close
    when nothing is published; a STATE request one chunk of the published
    state (a well-formed empty transfer when there is none); a RELAY
    request the report of a header probe of the target this server runs
    for the asker (:meth:`_handle_relay`); anything else is closed
    unanswered."""

    def __init__(self, host: str, port: int):
        self._lock = threading.Lock()
        self._segments: Optional[tuple] = None
        self._state: Union[bytes, _LazyState, None] = None
        self._state_gen = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, port))
            self._sock.listen(16)
        except OSError:
            self._sock.close()
            raise
        self.port = self._sock.getsockname()[1]  # port 0 resolved
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name=f"dpwa-torch-rx:{self.port}", daemon=True
        )
        self._thread.start()

    def publish(
        self, payload: torch.Tensor, clock: float, loss: float, digest: Optional[bytes] = None
    ) -> None:
        """Serve ``payload`` (a host tensor the caller no longer changes)
        with ``clock`` and ``loss``, and ``digest`` as its trailer, from now
        on."""
        segments = _frame_segments(payload, clock, loss, digest)
        with self._lock:
            self._segments = segments

    def publish_state(self, blob: Union[bytes, Callable[[], bytes]]) -> None:
        """Serve a packed train state for a peer's bootstrap from now on:
        bytes (copied unless they are ``bytes`` already), or a callable
        that packs them, called once, at the first STATE request of this
        publish (what it reads must not change until then).  Each publish
        bumps the generation, so a transfer in flight against the old
        state restarts instead of splicing two."""
        state = _LazyState(blob) if callable(blob) else bytes(blob)
        with self._lock:
            self._state = state
            self._state_gen = (self._state_gen + 1) & 0xFFFFFFFF

    @property
    def _payload(self) -> Optional[bytes]:
        """The published frame as one byte string (for tests)."""
        segs = self._segments
        return None if segs is None else b"".join(bytes(s) for s in segs)

    def _serve(self) -> None:
        try:
            self._sock.settimeout(0.2)
        except OSError:
            return
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(
                target=self._conn_worker, args=(conn,),
                name=f"dpwa-torch-rx-conn:{self.port}", daemon=True,
            ).start()

    def _conn_worker(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(_HANDLER_TIMEOUT_S)
            self._handle(conn)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, conn: socket.socket) -> None:
        req = ingest.recv_exact_into(conn, len(pc.BLOB_REQ))
        if req == pc.STATE_REQ:
            body = ingest.recv_exact_into(conn, pc.STATE_REQ_BODY.size)
            self._handle_state(conn, *pc.STATE_REQ_BODY.unpack(body))
            return
        if req == pc.RELAY_REQ:
            self._handle_relay(conn)
            return
        if req != pc.BLOB_REQ:
            return
        with self._lock:
            segments = self._segments
        if segments is not None:
            ingest.sendall_segments(conn, segments)

    def _handle_relay(self, conn: socket.socket) -> None:
        """Serve one relayed header probe: probe the requested target and
        report the classified outcome and the target's publish clock (-1
        when unknown).  The probe's budget is clamped to
        ``MAX_RELAY_TIMEOUT_MS``, so an asker cannot pin this thread."""
        body = ingest.recv_exact_into(conn, pc.RELAY_BODY.size)
        _target, port, timeout_ms, hostlen = pc.RELAY_BODY.unpack(body)
        host = (
            str(bytes(ingest.recv_exact_into(conn, hostlen)), "ascii", "replace")
            if hostlen else "127.0.0.1"
        )
        timeout_ms = min(max(int(timeout_ms), 1), pc.MAX_RELAY_TIMEOUT_MS)
        outcome, clock = probe_header_classified(host, port, timeout_ms)
        conn.sendall(pc.RELAY_HDR.pack(
            pc.RELAY_MAGIC, 1, _RELAY_OUTCOMES.index(outcome),
            float(clock) if clock is not None else -1.0,
        ))

    def _handle_state(self, conn: socket.socket, offset: int, max_chunk: int) -> None:
        """Serve one STATE chunk at ``offset``: at most ``max_chunk`` bytes
        (and 64 MiB), with the generation, the total length and the
        chunk's CRC32 in its header.  No published state is the empty
        transfer (total 0), which a fetcher reads as "nothing here"."""
        with self._lock:
            state, gen = self._state, self._state_gen
        blob = state.get() if isinstance(state, _LazyState) else (state or b"")
        total = len(blob)
        off = min(max(offset, 0), total)
        n = min(max(max_chunk, 0), total - off, pc.MAX_STATE_CHUNK_BYTES)
        chunk = memoryview(blob)[off : off + n]
        header = pc.STATE_HDR.pack(pc.STATE_MAGIC, 1, gen, total, off, n, zlib.crc32(chunk))
        ingest.sendall_segments(conn, (header, chunk))

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


def make_peer_server(host: str, port: int) -> PeerServer:
    """The Rx server: the threaded :class:`PeerServer`.  The reference
    picks its native C++ server where it builds and falls back to this one;
    the port has no native server yet (nor the reactor, which
    ``protocol.rx_server: reactor`` asks for and :class:`TcpTransport`
    refuses)."""
    return PeerServer(host, port)


def _decode(data: memoryview, code: int):
    """``(vector, array)``: the flat payload as a CPU tensor viewing
    ``data`` through the numpy array it keeps alive, or None when its
    length is not a whole number of elements."""
    np_dtype, dtype = _FLAT[code]
    try:
        arr = np.frombuffer(data, dtype=np_dtype)
    except ValueError:
        return None
    t = torch.from_numpy(arr)
    return (t.view(torch.bfloat16) if dtype == torch.bfloat16 else t), arr


def _recv_trailing(sock: socket.socket, n: int, deadline: float) -> Optional[memoryview]:
    """An exact read of an optional trailing section: None, never a raise,
    on a timeout, EOF or reset (a peer that closed after its payload has
    no trailer: the old wire)."""
    try:
        return ingest.recv_exact_into(sock, n, deadline)
    except OSError:  # socket.timeout and ConnectionError included
        return None


def _read_trailers(sock: socket.socket, budget_s: float = _TRAILER_BUDGET_S) -> Optional[bytes]:
    """The membership digest among the trailers after a payload, or None.

    Reads a 4-byte magic, dispatches on it and repeats (at most 4
    sections): a digest (``DPWM``, its header and the entries its count
    implies) ends the read, since the sections after it (the
    observability section rides after the digest) carry nothing the port
    reads, and waiting for the server's close would cost a thread switch
    on its side; an observability section (``DPWT``) before any digest is
    read past and dropped; anything else, or a malformed or missing
    section, ends the read.  Never raises."""
    deadline = time.monotonic() + budget_s
    obs_seen = False
    for _ in range(4):
        magic = _recv_trailing(sock, 4, deadline)
        if magic is None:
            break
        if magic == pc.DIGEST_MAGIC:
            rest = _recv_trailing(sock, _digest.HEADER_SIZE - 4, deadline)
            if rest is None:
                break
            head = b"".join((magic, rest))
            nbytes = _digest.header_entries_nbytes(head)
            if nbytes is None:
                break
            body = _recv_trailing(sock, nbytes, deadline)
            if body is None:
                break
            return b"".join((head, body))
        elif magic == pc.OBS_MAGIC and not obs_seen:
            rest = _recv_trailing(sock, pc.OBS_HDR.size - 4, deadline)
            if rest is None:
                break
            _m, version, n, _trace, _loss, _res = pc.OBS_HDR.unpack(b"".join((magic, rest)))
            if version != pc.OBS_VERSION or n > pc.MAX_SKETCH_VALUES:
                break
            if _recv_trailing(sock, 4 * n, deadline) is None:
                break
            obs_seen = True
        else:
            break
    return None


def fetch_blob_full(
    host: str,
    port: int,
    timeout_ms: int,
    min_bandwidth_bps: float = _MIN_WIRE_BANDWIDTH,
    ring: Optional[ingest.BufferRing] = None,
    lease_box: Optional[list] = None,
    trailer_box: Optional[list] = None,
) -> Tuple[Optional[Tuple[torch.Tensor, float, float]], str, float, int]:
    """Fetch a peer's frame: ``(result, outcome, latency_s, payload bytes
    received)``, ``result`` = ``(vector, clock, loss)`` or None.

    ``outcome`` is a :class:`~dpwa_tpu_torch.health.detector.Outcome`:
    ``refused`` (the connect failed), ``timeout`` (the deadline lapsed with
    nothing received), ``slow`` (it lapsed while bytes flowed), ``busy``
    (the peer answered the BUSY shed frame), ``short_read`` (closed or
    reset mid-frame), ``corrupt`` (bad magic, version or code, oversize, a
    payload of no whole elements; also a reference codec frame, int8, top-k
    or sharded, which the port does not decode yet), ``success``.

    ``timeout_ms`` bounds connect, request and header together; the
    payload read earns ``1 / min_bandwidth_bps`` seconds for every byte
    received.  The payload lands in a lease of ``ring`` (a pageable one by
    default) and the vector is a CPU tensor viewing it: with ``lease_box``
    the lease is appended there and the caller releases it once nothing
    reads the vector; without, the lease returns to the ring when the
    vector dies.  With ``trailer_box`` the trailers after a valid payload
    are read too (:func:`_read_trailers`) and the membership digest's
    bytes, or None, appended there."""
    ring = ring if ring is not None else _default_ring()
    t0 = time.monotonic()
    deadline = t0 + timeout_ms / 1000.0
    rx = [0]  # bytes received, surviving a timeout: slow vs timeout
    nbytes_rx = 0
    lease = None

    def done(outcome, result=None):
        return result, outcome, time.monotonic() - t0, nbytes_rx

    try:
        sock = socket.create_connection((host, port), timeout=timeout_ms / 1000.0)
    except socket.timeout:
        return done(Outcome.TIMEOUT)
    except OSError:
        return done(Outcome.REFUSED)
    try:
        with sock:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("cumulative fetch deadline exceeded before request")
            sock.settimeout(remaining)
            sock.sendall(pc.BLOB_REQ)
            hdr = bytearray(max(pc.BLOB_HDR.size, pc.BUSY_HDR.size))
            peek = ingest.recv_exact_into(sock, 4, deadline, progress=rx, out=hdr)
            if peek == pc.BUSY_MAGIC:
                ingest.recv_exact_into(
                    sock, pc.BUSY_HDR.size - 4, deadline, progress=rx, out=memoryview(hdr)[4:]
                )
                _magic, version, _retry_ms = pc.BUSY_HDR.unpack_from(hdr, 0)
                return done(Outcome.BUSY if version == 1 else Outcome.CORRUPT)
            ingest.recv_exact_into(
                sock, pc.BLOB_HDR.size - 4, deadline, progress=rx, out=memoryview(hdr)[4:]
            )
            magic, version, code, clock, loss, nbytes = pc.BLOB_HDR.unpack_from(hdr, 0)
            if (
                magic != pc.BLOB_MAGIC or version != 1 or code not in _FLAT
                or nbytes > pc.MAX_BLOB_BYTES
            ):
                return done(Outcome.CORRUPT)
            per_byte = 1.0 / min_bandwidth_bps
            pre = 0
            if nbytes > _PROBE_THRESHOLD:
                probe = ring.lease(_PROBE_BYTES)
                try:
                    ingest.recv_exact_into(
                        sock, _PROBE_BYTES, deadline, per_byte, progress=rx, out=probe.view
                    )
                    try:
                        lease = ring.lease(nbytes)
                    except (MemoryError, RuntimeError, OverflowError):
                        return done(Outcome.CORRUPT)  # more than this host can hold
                    lease.view[:_PROBE_BYTES] = probe.view
                finally:
                    probe.release()
                pre = _PROBE_BYTES
            else:
                lease = ring.lease(nbytes)
            ingest.recv_exact_into(
                sock, nbytes - pre, deadline + pre * per_byte, per_byte,
                progress=rx, out=lease.view[pre:],
            )
            nbytes_rx = nbytes
            decoded = _decode(lease.view, code)
            if decoded is None:
                lease.release()
                lease = None
                return done(Outcome.CORRUPT)
            vec, arr = decoded
            del decoded
            if trailer_box is not None:
                trailer_box.append(_read_trailers(sock))
            ingest.note_rx_frame(0 if vec.dtype in (torch.float32, torch.bfloat16) else 1)
            if lease_box is not None:
                lease_box.append(lease)
            else:
                lease.recycle(arr)
            del arr
            lease = None
            return done(Outcome.SUCCESS, (vec, float(clock), float(loss)))
    except socket.timeout:
        if lease is not None:
            lease.release()
        return done(Outcome.SLOW if rx[0] > 0 else Outcome.TIMEOUT)
    except OSError:  # ConnectionError included: closed or reset mid-frame
        if lease is not None:
            lease.release()
        return done(Outcome.SHORT_READ)


# The reference's name for the fetch without trailers: fetch_blob_full
# without a trailer_box.
fetch_blob_ex = fetch_blob_full


def fetch_blob(host: str, port: int, timeout_ms: int,
               min_bandwidth_bps: float = _MIN_WIRE_BANDWIDTH):
    """A peer's ``(vector, clock, loss)``, or None when the fetch failed
    (the caller skips the merge and trains on)."""
    return fetch_blob_full(host, port, timeout_ms, min_bandwidth_bps)[0]


def fetch_state_chunk(
    host: str,
    port: int,
    offset: int,
    max_chunk: int,
    timeout_ms: int,
    min_bandwidth_bps: float = _MIN_WIRE_BANDWIDTH,
    out: Optional[memoryview] = None,
) -> Tuple[Optional[Tuple[memoryview, int, int]], str, float, int]:
    """Fetch one STATE chunk: ``(result, outcome, latency_s, bytes
    received)``, ``result`` = ``(chunk, total, generation)`` or None.

    The deadline is :func:`fetch_blob_full`'s: ``timeout_ms`` for connect,
    request and header, and ``1 / min_bandwidth_bps`` seconds more per
    byte of the chunk.  A bad header, a chunk longer than what remains (or
    than ``out``, the window of the caller's blob the chunk lands in), a
    CRC mismatch, or an offset the server clamped (its state shrank) is
    ``corrupt``."""
    t0 = time.monotonic()
    deadline = t0 + timeout_ms / 1000.0
    nbytes_rx = 0
    try:
        sock = socket.create_connection((host, port), timeout=timeout_ms / 1000.0)
    except socket.timeout:
        return None, Outcome.TIMEOUT, time.monotonic() - t0, 0
    except OSError:
        return None, Outcome.REFUSED, time.monotonic() - t0, 0
    try:
        with sock:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("cumulative state-fetch deadline exceeded before request")
            sock.settimeout(remaining)
            sock.sendall(pc.STATE_REQ + pc.STATE_REQ_BODY.pack(offset, max_chunk))
            raw = ingest.recv_exact_into(sock, pc.STATE_HDR.size, deadline)
            magic, version, gen, total, off, chunk_len, crc = pc.STATE_HDR.unpack(raw)
            if (
                magic != pc.STATE_MAGIC or version != 1 or total > pc.MAX_BLOB_BYTES
                or chunk_len > max(total - off, 0)
                or (out is not None and chunk_len > len(out))
            ):
                return None, Outcome.CORRUPT, time.monotonic() - t0, 0
            data = ingest.recv_exact_into(
                sock, chunk_len, deadline, 1.0 / min_bandwidth_bps, out=out
            )
            nbytes_rx = len(data)
            if zlib.crc32(data) != crc or off != min(max(offset, 0), total):
                return None, Outcome.CORRUPT, time.monotonic() - t0, nbytes_rx
            return (data, total, gen), Outcome.SUCCESS, time.monotonic() - t0, nbytes_rx
    except socket.timeout:
        return None, Outcome.TIMEOUT, time.monotonic() - t0, nbytes_rx
    except OSError:
        return None, Outcome.SHORT_READ, time.monotonic() - t0, nbytes_rx


def fetch_state(
    host: str,
    port: int,
    timeout_ms: int,
    chunk_bytes: int = 1 << 20,
    max_retries: int = 8,
    min_bandwidth_bps: float = _MIN_WIRE_BANDWIDTH,
) -> Tuple[Optional[bytes], str, float, int]:
    """A donor's whole packed state, chunk by chunk from offset 0, each
    chunk on a connection of its own and landing at its final offset:
    ``(blob or None, outcome, latency_s, bytes received)``.

    A timeout or short read resumes at the last banked offset; a corrupt
    chunk, or a generation or length that changed (the donor published
    anew), restarts from 0; each failure is charged to ``max_retries``
    across the transfer, and a refused connect ends it at once.  A donor
    with no state gives ``(b"", success)``; on failure ``outcome`` is the
    last chunk's."""
    t0 = time.monotonic()
    blob: Optional[bytearray] = None
    filled = 0
    total: Optional[int] = None
    gen: Optional[int] = None
    retries = 0
    nbytes_rx = 0

    def failed(outcome):
        return None, outcome, time.monotonic() - t0, nbytes_rx

    while True:
        window = memoryview(blob)[filled:] if blob is not None else None
        got, outcome, _lat, nrx = fetch_state_chunk(
            host, port, filled, chunk_bytes, timeout_ms, min_bandwidth_bps, out=window
        )
        nbytes_rx += nrx
        if got is None:
            if outcome == Outcome.REFUSED or retries >= max_retries:
                return failed(outcome)
            retries += 1
            if outcome == Outcome.CORRUPT:
                blob, filled, total, gen = None, 0, None, None
            continue
        data, tot, g = got
        if gen is not None and (g != gen or tot != total):
            if retries >= max_retries:
                return failed(Outcome.CORRUPT)
            retries += 1
            blob, filled, total, gen = None, 0, None, None
            continue
        gen, total = g, tot
        if blob is None:
            blob = bytearray(total)
            blob[: len(data)] = data
            filled = len(data)
        else:
            filled += len(data)  # received in place, at blob[filled:]
        if filled >= total:
            return bytes(memoryview(blob)[:total]), Outcome.SUCCESS, time.monotonic() - t0, nbytes_rx
        if not len(data):
            if retries >= max_retries:
                return failed(Outcome.CORRUPT)
            retries += 1


def probe_header_classified(
    host: str, port: int, timeout_ms: int = 100
) -> Tuple[str, Optional[float]]:
    """Header-only liveness probe: ``(outcome, publish clock or None)``.

    A blob request whose reply is read to the end of its header and
    abandoned (the server's send into the closed socket ends that
    connection), so a quarantined peer costs no payload.  ``success``
    needs a well-formed header (a codec's payload code included); a BUSY
    reply is ``busy``; failures are classified as the fetch's."""
    deadline = time.monotonic() + timeout_ms / 1000.0
    try:
        sock = socket.create_connection((host, port), timeout=timeout_ms / 1000.0)
    except socket.timeout:
        return Outcome.TIMEOUT, None
    except OSError:
        return Outcome.REFUSED, None
    try:
        with sock:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return Outcome.TIMEOUT, None
            sock.settimeout(remaining)
            sock.sendall(pc.BLOB_REQ)
            hdr = bytearray(max(pc.BLOB_HDR.size, pc.BUSY_HDR.size))
            peek = ingest.recv_exact_into(sock, 4, deadline, out=hdr)
            if peek == pc.BUSY_MAGIC:
                ingest.recv_exact_into(sock, pc.BUSY_HDR.size - 4, deadline,
                                       out=memoryview(hdr)[4:])
                _magic, version, _retry_ms = pc.BUSY_HDR.unpack_from(hdr, 0)
                return (Outcome.BUSY if version == 1 else Outcome.CORRUPT), None
            ingest.recv_exact_into(sock, pc.BLOB_HDR.size - 4, deadline, out=memoryview(hdr)[4:])
            magic, version, code, clock, _loss, nbytes = pc.BLOB_HDR.unpack_from(hdr, 0)
            if (
                magic != pc.BLOB_MAGIC or version != 1
                or (code not in _FLAT and code not in pc.CODEC_PAYLOAD_CODES)
                or nbytes > pc.MAX_BLOB_BYTES
            ):
                return Outcome.CORRUPT, None
            return Outcome.SUCCESS, float(clock)
    except socket.timeout:
        return Outcome.TIMEOUT, None
    except OSError:
        return Outcome.SHORT_READ, None


def relay_probe(
    relay_host: str,
    relay_port: int,
    target_index: int,
    target_host: str,
    target_port: int,
    probe_timeout_ms: int,
    timeout_ms: int,
) -> Tuple[str, Optional[str], Optional[float]]:
    """Ask a relay to header-probe ``target`` on our behalf (the SWIM
    indirect probe): ``(relay_outcome, probe_outcome, clock)``.
    ``relay_outcome`` classifies our connection to the relay,
    ``probe_outcome`` is the relay's classified probe of the target (None
    when the relay leg failed) and ``clock`` the target's publish clock as
    the relay saw it (None when unknown).  ``timeout_ms`` must exceed
    ``probe_timeout_ms``: the relay probes before it answers."""
    deadline = time.monotonic() + timeout_ms / 1000.0
    try:
        sock = socket.create_connection((relay_host, relay_port), timeout=timeout_ms / 1000.0)
    except socket.timeout:
        return Outcome.TIMEOUT, None, None
    except OSError:
        return Outcome.REFUSED, None, None
    try:
        with sock:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return Outcome.TIMEOUT, None, None
            sock.settimeout(remaining)
            host_b = target_host.encode("ascii", "replace")[:255]
            sock.sendall(
                pc.RELAY_REQ
                + pc.RELAY_BODY.pack(
                    target_index & 0xFFFF, target_port & 0xFFFF,
                    int(probe_timeout_ms) & 0xFFFFFFFF, len(host_b),
                )
                + host_b
            )
            raw = ingest.recv_exact_into(sock, pc.RELAY_HDR.size, deadline)
            magic, version, code, clock = pc.RELAY_HDR.unpack(raw)
            if magic != pc.RELAY_MAGIC or version != 1 or code >= len(_RELAY_OUTCOMES):
                return Outcome.CORRUPT, None, None
            return Outcome.SUCCESS, _RELAY_OUTCOMES[code], (float(clock) if clock >= 0 else None)
    except socket.timeout:
        return Outcome.TIMEOUT, None, None
    except OSError:
        return Outcome.SHORT_READ, None, None


def probe_header_ex(host: str, port: int, timeout_ms: int = 100) -> Tuple[bool, Optional[float]]:
    """:func:`probe_header_classified` as ``(ok, clock)``."""
    outcome, clock = probe_header_classified(host, port, timeout_ms)
    return outcome == Outcome.SUCCESS, clock


def probe_header(host: str, port: int, timeout_ms: int = 100) -> bool:
    """Whether a live Rx server serves a well-formed frame there."""
    return probe_header_ex(host, port, timeout_ms)[0]


_RING_LOCK = threading.Lock()
_RING: list = []


def _default_ring() -> ingest.BufferRing:
    """The process's pageable receive ring, made at first use."""
    with _RING_LOCK:
        if not _RING:
            _RING.append(ingest.BufferRing())
        return _RING[0]


def _unsupported(config: DpwaConfig) -> Optional[str]:
    proto = config.protocol
    if proto.wire_dtype not in _WIRE_CODES:
        return f"protocol.wire_dtype: {proto.wire_dtype} (the int8-chunked codec)"
    if proto.wire_codec != "dense":
        return f"protocol.wire_codec: {proto.wire_codec} (the top-k codec)"
    if proto.overlap_prefetch:
        return "protocol.overlap_prefetch: true (the prefetch pipeline)"
    if proto.rx_server != "threaded":
        return f"protocol.rx_server: {proto.rx_server} (the reactor Rx server)"
    if config.health.enabled and config.health.healthz_port is not None:
        return f"health.healthz_port: {config.health.healthz_port} (the /healthz endpoint)"
    return None


def _flat(vec: torch.Tensor) -> torch.Tensor:
    """``vec`` itself when it is flat (the replica is recognised by
    identity), else its flat view."""
    return vec if vec.dim() == 1 else vec.reshape(-1)


class TcpTransport:
    """Per-process gossip transport; ``name`` picks this node's entry of
    the YAML ``nodes:`` list, whose host and port it serves on.

    ``device`` is where its replicas merge and land: the CUDA card by
    default (the receive ring is then pinned), ``"cpu"`` on purpose.
    With ``health.enabled`` (the default) :attr:`scoreboard` holds the
    peers' health, with ``membership.enabled`` too :attr:`membership` its
    epidemic view, with ``trust.enabled`` :attr:`trust` the content-trust
    state; :attr:`last_round` says each round's scheduled and actual
    partner, whether it was remapped, the fetch's outcome and the trust
    verdict."""

    def __init__(self, config: DpwaConfig, name: str, device=None):
        missing = _unsupported(config)
        if missing is not None:
            raise NotImplementedError(
                f"{missing} is not ported to dpwa_tpu_torch's TCP transport yet"
            )
        self.config = config
        self.me = config.node_index(name)
        self.device = resolve_device(device)
        self.schedule: Schedule = build_schedule(config)
        n = len(config.nodes)
        # The content-trust plane screens every fetched payload; the current
        # exchange's damping reaches the interpolation through
        # _pending_trust_scale (1.0, fully trusted, changes α by nothing).
        self.trust: Optional[TrustManager] = (
            TrustManager(n, self.me, config.trust) if config.trust.enabled else None
        )
        self._pending_trust_scale = 1.0
        # The replica the screen compares with: the one last published.
        self._local_vec: Optional[torch.Tensor] = None
        self.interp = make_interpolation(
            config.interpolation,
            max_abs_loss=(
                config.recovery.rescue_bound() if config.recovery.enabled else None
            ),
            trust_scale=(lambda: self._pending_trust_scale) if self.trust is not None else None,
        )
        self.wire = config.protocol.wire_dtype
        self.ring = ingest.BufferRing(pinned=self.device.type == "cuda")
        self._dev_replica: Optional[DeviceReplica] = None
        self._local_norm: Optional[float] = None
        spec = config.nodes[self.me]
        self.server = make_peer_server(spec.host, spec.port)
        self._ports = {i: (n.host, n.port) for i, n in enumerate(config.nodes)}
        # Every fetch outcome feeds the scoreboard; a quarantined partner
        # is probed or remapped in _resolve_partner.
        self.scoreboard: Optional[Scoreboard] = (
            Scoreboard(n, self.me, config.health, seed=self.schedule.seed)
            if config.health.enabled else None
        )
        # Epidemic membership rides on the scoreboard; an evicted peer's
        # trust records are pruned with its scoreboard records.
        self.membership: Optional[MembershipManager] = None
        if self.scoreboard is not None and config.membership.enabled:
            self.membership = MembershipManager(
                n, self.me, self.scoreboard, config.membership, seed=self.schedule.seed
            )
            if self.trust is not None:
                self.membership.add_evict_listener(self.trust.evict_peer)
        if self.trust is not None and self.scoreboard is not None:
            # Collapsed trust feeds the scoreboard as untrusted probes.
            self.trust.attach_scoreboard(self.scoreboard)
        self.last_digest_nbytes = 0
        # The clock last published (the probe's freshness check reads it)
        # and the re-sync advice pending for the adapter.
        self._last_clock = 0.0
        self.resync_advice: Optional[dict] = None
        missing_planes = config.unported_planes()
        if missing_planes:
            warnings.warn(
                f"node {name!r} runs without the reference's default-on "
                f"{', '.join(missing_planes)} plane(s), which dpwa_tpu_torch does not "
                f"have yet; a dpwa_tpu node under this config runs them (switch them "
                f"off with 'enabled: false' to silence this)",
                stacklevel=2,
            )
        self._stats_lock = threading.Lock()
        self.stats = {
            "frames_published": 0, "wire_bytes_published": 0,
            "rounds": 0, "merged": 0, "wire_bytes_fetched": 0,
            "outcomes": {}, "verdicts": {}, "probes": 0, "relay_probes": 0,
            # peer -> [merged rounds, the newest publish clock merged]
            "merged_from": {},
        }
        self._round_clock: Optional[float] = None
        self.last_fetch: dict = {}
        self.last_round: dict = {}

    @property
    def port(self) -> int:
        return self.server.port

    def set_peer_port(self, index: int, port: int) -> None:
        """Point peer ``index`` at another port (tests bind to port 0)."""
        host, _ = self._ports[index]
        self._ports[index] = (host, port)

    # -- publish --------------------------------------------------------
    def _serve(self, payload: torch.Tensor, clock: float, loss: float) -> None:
        nbytes = payload.numel() * payload.element_size()
        with self._stats_lock:
            self.stats["frames_published"] += 1
            self.stats["wire_bytes_published"] += nbytes
        # The epidemic piggyback: this node's view rides every frame.
        digest = self.membership.encode(int(clock)) if self.membership is not None else None
        if digest is not None:
            self.last_digest_nbytes = len(digest)
        self.server.publish(payload, clock, loss, digest)

    def _replica(self, flat: torch.Tensor) -> DeviceReplica:
        """The replica that holds ``flat``: the current one when it does
        (its host mirror then serves again), else a new one."""
        rep = self._dev_replica
        if rep is None or rep.dev is not flat:
            rep = DeviceReplica(flat)
            self._dev_replica = rep
        return rep

    def publish(self, vec, clock: float, loss: float) -> None:
        """Serve a float32 replica on this node's wire from now on: a host
        vector (numpy array or CPU tensor) or a tensor on the card, whose
        wire payload is read back.  The frame is a snapshot.  A tensor is
        adopted as the replica, so an :meth:`exchange_on_device` of the
        same tensor right after publishes it again without a readback."""
        if isinstance(vec, np.ndarray):
            vec = torch.from_numpy(np.ascontiguousarray(vec, dtype=np.float32))
        self._publish_replica(self._replica(_flat(vec)), clock, loss)

    def _publish_replica(self, rep: DeviceReplica, clock: float, loss: float) -> None:
        self._last_clock = float(clock)
        if self.trust is not None:
            self._local_vec = rep.dev
        self._serve(rep.payload(self.wire), clock, loss)
        if self.config.recovery.enabled and self.config.recovery.min_param_norm_ratio > 0.0:
            self._local_norm = rep.norm()

    # -- fetch ----------------------------------------------------------
    def fetch(self, peer_index: int, timeout_ms: Optional[int] = None,
              step: Optional[int] = None, device=None):
        """Fetch, land, guard and screen ``peer_index``'s frame: ``(vector,
        clock, loss)`` with the vector on ``device`` (the CPU by default;
        float32, or bf16 as the wire carried it), or None if the fetch
        failed, the guard refused it (``poisoned``) or the trust screen
        rejected it (``untrusted``).  The frame's digest is merged into the
        membership view; a failure that would quarantine the peer first
        asks relays to probe it.  :attr:`last_fetch` holds the outcome,
        which the scoreboard records against round ``step``."""
        if timeout_ms is None:
            timeout_ms = self.config.protocol.timeout_ms
        device = torch.device("cpu") if device is None else torch.device(device)
        host, port = self._ports[peer_index]
        box: list = []
        trailers: Optional[list] = [] if self.membership is not None else None
        got, outcome, latency_s, nbytes = fetch_blob_full(
            host, port, timeout_ms,
            min_bandwidth_bps=self.config.protocol.min_wire_mb_per_s * 1e6,
            ring=self.ring, lease_box=box, trailer_box=trailers,
        )
        digest = trailers[0] if trailers else None
        reason = trust_info = None
        self._pending_trust_scale = 1.0
        if got is not None:
            vec, rclock, rloss = got
            del got
            if vec.dtype not in (torch.float32, torch.bfloat16):
                vec = vec.to(torch.float32)  # an f64 or u16 frame: one copy
            landed, event = to_device(vec, device)
            if event is not None:
                event.synchronize()
            del vec
            box.pop().release()
            got = (landed, rclock, rloss)
            reason, sums = self._judge(peer_index, landed, rloss)
            if reason is not None:
                got = None
                outcome = Outcome.POISONED
            elif self.trust is not None and self._local_vec is not None:
                # The screen judges the landed vector, as it would merge;
                # a rejection is the untrusted outcome, recorded as
                # poisoned is (and, like it, never gated behind relays).
                verdict, scale, tstats = self.trust.screen(
                    peer_index, landed, rclock, self._local_vec, round=step,
                    stats=None if sums is None else stats_from_sums(sums),
                )
                trust_info = dict(tstats, verdict=verdict, alpha_scale=round(scale, 4))
                with self._stats_lock:
                    counts = self.stats["verdicts"]
                    counts[verdict] = counts.get(verdict, 0) + 1
                if verdict == REJECTED:
                    got = None
                    outcome = Outcome.UNTRUSTED
                else:
                    self._pending_trust_scale = scale
        self.last_fetch = {
            "peer": peer_index, "outcome": outcome,
            "latency_s": latency_s, "nbytes": nbytes,
        }
        if reason is not None:
            self.last_fetch["poison_reason"] = reason
        if trust_info is not None:
            self.last_fetch["trust"] = trust_info
        with self._stats_lock:
            self.stats["wire_bytes_fetched"] += nbytes
            counts = self.stats["outcomes"]
            counts[outcome] = counts.get(outcome, 0) + 1
        if self.membership is not None and digest is not None:
            self.membership.merge(digest, round=step)
        sb = self.scoreboard
        if (
            self.membership is not None
            and sb is not None
            and step is not None
            and outcome in (Outcome.TIMEOUT, Outcome.REFUSED, Outcome.SHORT_READ, Outcome.CORRUPT)
            and self.config.membership.indirect_probes > 0
            and sb.would_quarantine(peer_index, outcome)
        ):
            # This failure would quarantine the peer on our evidence alone:
            # ask relays first (an asymmetric link is not a dead peer).
            self._indirect_probe(peer_index, step)
        if sb is not None:
            sb.record(peer_index, outcome, latency_s=latency_s, nbytes=nbytes, round=step)
        return got

    def _judge(self, peer_index: int, landed: torch.Tensor, rloss: float):
        """The guard's verdict on a landed frame and the trust screen's five
        sums, read back together: ``(poison reason or None, sums or
        None)``.  The sums are computed only when the screen will run on a
        vector of the local replica's length (else it computes or rejects
        on its own)."""
        local = self._local_vec
        sums = None
        if self.trust is not None and local is not None and landed.numel() == local.numel():
            sums = payload_sums(
                local, landed.to(local.device), self.trust.leaf_starts(local.numel())
            )
        if not self.config.recovery.enabled:
            return None, (None if sums is None else sums.tolist())
        checks = payload_check_tensors(landed)
        if sums is not None:
            checks = torch.cat([checks, sums.to(device=checks.device, dtype=torch.float64)])
        values = checks.tolist()
        reason = validate_payload(
            landed, rloss, self.config.recovery, local_norm=self._local_norm, checks=values[:2]
        )
        return reason, (values[2:] if sums is not None else None)

    def _indirect_probe(self, suspect: int, step: int) -> None:
        """Ask ``indirect_probes`` drawn healthy peers to header-probe
        ``suspect`` for us (the RELAY verb) and feed the scoreboard at most
        one summarized outcome for it: a success when any relay vouched.
        Each relay's own reachability feeds its record too.  The relays are
        :func:`~dpwa_tpu_torch.parallel.schedules.relay_draw`'s, keyed on
        (seed, step, me, slot)."""
        sb = self.scoreboard
        candidates = [
            p for p in range(len(self.config.nodes))
            if p != self.me and p != suspect and sb.state(p) == PeerState.HEALTHY
        ]
        if not candidates:
            return
        k = min(int(self.config.membership.indirect_probes), len(candidates))
        s_host, s_port = self._ports[suspect]
        vouched = False
        for slot in range(k):
            relay = candidates.pop(relay_draw(self.schedule.seed, step, self.me, slot,
                                              len(candidates)))
            r_host, r_port = self._ports[relay]
            with self._stats_lock:
                self.stats["relay_probes"] += 1
            relay_outcome, probe_outcome, _clock = relay_probe(
                r_host, r_port, suspect, s_host, s_port,
                self.config.health.probe_timeout_ms, self.config.membership.relay_timeout_ms,
            )
            sb.record_probe(relay, relay_outcome, round=step)
            vouched |= probe_outcome == Outcome.SUCCESS
        if vouched:
            sb.record_probe(suspect, Outcome.SUCCESS, round=step)

    # -- health and recovery --------------------------------------------
    def _resolve_partner(self, step: int) -> Tuple[int, int, bool]:
        """``(scheduled, actual, remapped)`` for this round.

        A quarantined partner whose backoff has run out gets a header
        probe first (the probe rides the rounds that would have fetched
        from it); if it is quarantined after that, the round goes to
        :meth:`Schedule.remap_partner`'s healthy fallback.  A successful
        probe whose clock leads ours by more than
        ``recovery.max_clock_lag`` leaves re-sync advice: we are the stale
        replica.  Without health, the scheduled partner."""
        sched = self.schedule.partner(step, self.me)
        partner, remapped = sched, False
        sb = self.scoreboard
        if sb is not None and sched != self.me:
            if sb.probe_due(sched, step):
                with self._stats_lock:
                    self.stats["probes"] += 1
                host, port = self._ports[sched]
                outcome, remote_clock = probe_header_classified(
                    host, port, self.config.health.probe_timeout_ms
                )
                sb.record_probe(sched, outcome, round=step)
                local_clock = self._last_clock
                if (
                    outcome == Outcome.SUCCESS
                    and remote_clock is not None
                    and self.config.recovery.enabled
                    and remote_clock - local_clock > self.config.recovery.max_clock_lag
                ):
                    self.resync_advice = {
                        "peer": sched, "remote_clock": float(remote_clock),
                        "local_clock": float(local_clock), "step": int(step),
                    }
            if sb.is_quarantined(sched, step):
                partner = self.schedule.remap_partner(step, self.me, sched, sb.healthy_mask(step))
                remapped = True
        return sched, partner, remapped

    def publish_state(self, blob: Union[bytes, Callable[[], bytes]]) -> None:
        """Serve this node's packed state for a peer's bootstrap (bytes, or
        a callable packing them at the first request:
        :meth:`PeerServer.publish_state`)."""
        self.server.publish_state(blob)

    def fetch_state(self, peer_index: int, timeout_ms: Optional[int] = None):
        """A donor's whole packed state over the STATE wire
        (:func:`fetch_state`), sized by the ``recovery:`` block."""
        host, port = self._ports[peer_index]
        rec = self.config.recovery
        return fetch_state(
            host, port, rec.bootstrap_timeout_ms if timeout_ms is None else timeout_ms,
            chunk_bytes=rec.state_chunk_bytes, max_retries=rec.max_resume_retries,
            min_bandwidth_bps=self.config.protocol.min_wire_mb_per_s * 1e6,
        )

    def pop_resync_advice(self) -> Optional[dict]:
        """Consume the pending re-sync advice, if any."""
        advice, self.resync_advice = self.resync_advice, None
        return advice

    def pop_membership_events(self) -> list:
        """Drain the membership events (refutations, component changes,
        partition entered and healed, evictions and rejoins)."""
        return [] if self.membership is None else self.membership.pop_events()

    def pop_heal_advice(self) -> Optional[dict]:
        """Consume the pending heal-reconciliation advice, if any."""
        return None if self.membership is None else self.membership.pop_heal_advice()

    def pop_trust_events(self) -> list:
        """Drain the trust events (collapse, recovery, amnesty, clock
        resets)."""
        return [] if self.trust is None else self.trust.pop_events()

    def set_trust_leaves(self, sizes) -> None:
        """Adopt the model's leaf sizes, in the frame's order, so the
        screen's per-leaf statistic follows the real parameter boundaries
        (adapters call this once)."""
        if self.trust is not None:
            self.trust.set_leaf_sizes(sizes)

    def health_snapshot(self) -> dict:
        """JSON-ready per-peer health: the scoreboard's snapshot (with the
        membership view when that plane runs), plus each peer's trust
        columns and a top-level ``trust`` view when the trust plane runs."""
        if self.scoreboard is None:
            snap = {"me": self.me, "round": 0, "peers": {}}
        else:
            snap = self.scoreboard.snapshot()
        if self.trust is not None:
            tsnap = self.trust.snapshot()
            for p, info in tsnap["peers"].items():
                snap["peers"].setdefault(p, {}).update(info)
            snap["trust"] = tsnap
        return snap

    # -- the round ------------------------------------------------------
    def _weigh(self, got: tuple, clock: float, loss: float) -> float:
        """The interpolation α for a fetched frame, in float32 as the
        reference's (the trust damping included), scaled by the membership
        plane's degraded-mode factor."""
        _vec, remote_clock, remote_loss = got
        as_meta = lambda c, l: PeerMeta(
            torch.tensor([c], dtype=torch.float32), torch.tensor([l], dtype=torch.float32)
        )
        alpha = float(self.interp(as_meta(clock, loss), as_meta(remote_clock, remote_loss))[0])
        if self.membership is not None:
            alpha *= self.membership.alpha_scale()
        return alpha

    def _round(self, rep: DeviceReplica, clock: float, loss: float, step: int):
        """Publish, resolve the partner, check participation, fetch, guard,
        screen, weigh: ``(remote or None, α, partner)``; None skips the
        merge.  The membership round boundary runs on every exit."""
        try:
            self._publish_replica(rep, clock, loss)
            sched, partner, remapped = self._resolve_partner(step)
            self.last_round = {
                "step": step, "sched_partner": sched, "partner": partner,
                "remapped": remapped, "outcome": None,
            }
            # Participation stays keyed on the scheduled pairing; a remap
            # moves only the fetch (to self when no healthy peer is left).
            if partner == self.me or not self.schedule.participates(step, self.me):
                return None, 0.0, partner
            got = self.fetch(partner, step=step, device=rep.dev.device)
            self.last_round["outcome"] = self.last_fetch.get("outcome")
            if "trust" in self.last_fetch:
                self.last_round["trust"] = self.last_fetch["trust"]
            if got is None:
                return None, 0.0, partner
            self._round_clock = got[1]
            return got[0], self._weigh(got, clock, loss), partner
        finally:
            # Component and quorum state advance on skipped rounds too: a
            # partitioned node skips every round, which is when it must
            # notice.
            if self.membership is not None:
                self.membership.end_round(step)

    def exchange_on_device(self, vec_dev: torch.Tensor, clock: float, loss: float, step: int):
        """One gossip round for a flat float32 replica on the card (or any
        device): ``(merged, α, partner)``, the merged replica a new tensor
        on the same device, or ``vec_dev`` itself when the round was
        skipped (α = 0)."""
        rep = self._replica(_flat(vec_dev))
        remote, alpha, partner = self._round(rep, clock, loss, step)
        with self._stats_lock:
            self.stats["rounds"] += 1
            self.stats["merged"] += remote is not None
            if remote is not None:
                seen = self.stats["merged_from"].setdefault(partner, [0, self._round_clock])
                seen[0] += 1
                seen[1] = max(seen[1], self._round_clock)
        if remote is None:
            return rep.dev, alpha, partner
        merged = engine.merge(rep.dev, remote, alpha)
        rep.swap(merged)
        return merged, alpha, partner

    def exchange(self, vec, clock: float, loss: float, step: int):
        """One gossip round for a host replica (a float32 numpy array or
        CPU tensor), merged on the CPU: ``(merged, α, partner)`` of the
        same kind, ``vec`` itself when the round was skipped."""
        as_numpy = isinstance(vec, np.ndarray)
        t = torch.from_numpy(np.ascontiguousarray(vec, dtype=np.float32)) if as_numpy else vec
        flat = _flat(t)
        merged, alpha, partner = self.exchange_on_device(flat, clock, loss, step)
        if merged is flat:
            return vec, alpha, partner
        return (merged.numpy() if as_numpy else merged), alpha, partner

    def close(self) -> None:
        self.server.close()
