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
rounds it.  A port node and a ``dpwa_tpu`` node gossip with each other;
the fetcher reads the header and ``nbytes`` and stops, so the trailers a
reference node appends (its membership digest) are left unread, as the
reference's own fetchers without membership leave them.

:meth:`TcpTransport.exchange_on_device` merges a replica that lives on the
card: the publish reads back only the wire's bytes and only once per merge
(:class:`~dpwa_tpu_torch.device.replica.DeviceReplica`), the frame lands in
a pinned receive buffer and crosses to the card by an asynchronous copy,
the guard runs there, and the merge is one launch of B2 over ``[1, d]``
(:func:`~dpwa_tpu_torch.device.engine.merge`).
:meth:`TcpTransport.exchange` is the same round for a host vector, merged
on the CPU by B2's plain version.

Ported: the threaded Rx server, the classified fetch (refused, timeout,
slow, busy, short_read, corrupt, poisoned, success), every schedule of the
port with ``fetch_probability`` and ``drop_probability``, the constant,
clock and loss interpolations, and the pre-merge guard.  Not yet: the
codecs (``wire_dtype: int8``, ``wire_codec: topk``, ``shard:``), the
prefetch pipeline, the reactor and native Rx servers, the STATE and RELAY
wires and the control planes; the transport raises
:class:`NotImplementedError` for the settings that ask for them.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from dpwa_tpu_torch.config import DEFAULT_MIN_WIRE_MB_PER_S, DpwaConfig
from dpwa_tpu_torch.device import engine
from dpwa_tpu_torch.device.handoff import to_device
from dpwa_tpu_torch.device.replica import DeviceReplica
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.interpolation import PeerMeta, make_interpolation
from dpwa_tpu_torch.parallel import ingest
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel.schedules import Schedule, build_schedule
from dpwa_tpu_torch.recovery.guard import validate_payload
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


def _frame_segments(payload: torch.Tensor, clock: float, loss: float) -> tuple:
    """``(header, payload bytes)``: the wire frame as the segments the
    server sends, the payload a view of ``payload``'s host memory (which
    the caller must not change while it is served).  The code follows the
    payload's dtype: float32, float64 or bf16."""
    code = next(c for c, (_, dt) in _FLAT.items() if dt == payload.dtype)
    flat = payload.reshape(-1).contiguous()
    if flat.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    data = flat.numpy().view(np.uint8)
    header = pc.BLOB_HDR.pack(pc.BLOB_MAGIC, 1, code, float(clock), float(loss), data.size)
    return header, data


def _frame(payload: torch.Tensor, clock: float, loss: float) -> bytes:
    """:func:`_frame_segments` joined: the frame as one byte string."""
    return b"".join(bytes(s) for s in _frame_segments(payload, clock, loss))


class PeerServer:
    """The Rx thread: serves this node's latest published frame.

    One thread accepts; each connection gets a thread of its own with a
    bounded budget.  A blob request gets the frame; a STATE request the
    well-formed empty transfer the reference's server gives when no state
    is published (the port serves no state yet); a RELAY request, or
    anything else, is closed unanswered, as the reference's native server
    does."""

    def __init__(self, host: str, port: int):
        self._lock = threading.Lock()
        self._segments: Optional[tuple] = None
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

    def publish(self, payload: torch.Tensor, clock: float, loss: float) -> None:
        """Serve ``payload`` (a host tensor the caller no longer changes)
        with ``clock`` and ``loss`` from now on."""
        segments = _frame_segments(payload, clock, loss)
        with self._lock:
            self._segments = segments

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
            ingest.recv_exact_into(conn, pc.STATE_REQ_BODY.size)
            empty = pc.STATE_HDR.pack(pc.STATE_MAGIC, 1, 0, 0, 0, 0, 0)
            conn.sendall(empty)  # crc32 of no bytes is 0
            return
        if req != pc.BLOB_REQ:
            return
        with self._lock:
            segments = self._segments
        if segments is not None:
            ingest.sendall_segments(conn, segments)

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


def fetch_blob_full(
    host: str,
    port: int,
    timeout_ms: int,
    min_bandwidth_bps: float = _MIN_WIRE_BANDWIDTH,
    ring: Optional[ingest.BufferRing] = None,
    lease_box: Optional[list] = None,
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
    vector dies."""
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


# The reference's name for the fetch without trailers: the port reads none,
# so it is fetch_blob_full itself.
fetch_blob_ex = fetch_blob_full


def fetch_blob(host: str, port: int, timeout_ms: int,
               min_bandwidth_bps: float = _MIN_WIRE_BANDWIDTH):
    """A peer's ``(vector, clock, loss)``, or None when the fetch failed
    (the caller skips the merge and trains on)."""
    return fetch_blob_full(host, port, timeout_ms, min_bandwidth_bps)[0]


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
    return None


def _flat(vec: torch.Tensor) -> torch.Tensor:
    """``vec`` itself when it is flat (the replica is recognised by
    identity), else its flat view."""
    return vec if vec.dim() == 1 else vec.reshape(-1)


class TcpTransport:
    """Per-process gossip transport; ``name`` picks this node's entry of
    the YAML ``nodes:`` list, whose host and port it serves on.

    ``device`` is where its replicas merge and land: the CUDA card by
    default (the receive ring is then pinned), ``"cpu"`` on purpose."""

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
        self.interp = make_interpolation(
            config.interpolation,
            max_abs_loss=(
                config.recovery.rescue_bound() if config.recovery.enabled else None
            ),
        )
        self.wire = config.protocol.wire_dtype
        self.ring = ingest.BufferRing(pinned=self.device.type == "cuda")
        self._dev_replica: Optional[DeviceReplica] = None
        self._local_norm: Optional[float] = None
        spec = config.nodes[self.me]
        self.server = make_peer_server(spec.host, spec.port)
        self._ports = {i: (n.host, n.port) for i, n in enumerate(config.nodes)}
        self._stats_lock = threading.Lock()
        self.stats = {
            "frames_published": 0, "wire_bytes_published": 0,
            "rounds": 0, "merged": 0, "wire_bytes_fetched": 0,
            "outcomes": {},
        }
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
        self.server.publish(payload, clock, loss)

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
        self._serve(rep.payload(self.wire), clock, loss)
        if self.config.recovery.enabled and self.config.recovery.min_param_norm_ratio > 0.0:
            self._local_norm = rep.norm()

    # -- fetch ----------------------------------------------------------
    def fetch(self, peer_index: int, timeout_ms: Optional[int] = None,
              step: Optional[int] = None, device=None):
        """Fetch, land and guard ``peer_index``'s frame: ``(vector, clock,
        loss)`` with the vector on ``device`` (the CPU by default; float32,
        or bf16 as the wire carried it), or None if the fetch failed or the
        guard refused it.  :attr:`last_fetch` holds the outcome."""
        del step  # the health plane that would record against it is not ported
        if timeout_ms is None:
            timeout_ms = self.config.protocol.timeout_ms
        device = torch.device("cpu") if device is None else torch.device(device)
        host, port = self._ports[peer_index]
        box: list = []
        got, outcome, latency_s, nbytes = fetch_blob_full(
            host, port, timeout_ms,
            min_bandwidth_bps=self.config.protocol.min_wire_mb_per_s * 1e6,
            ring=self.ring, lease_box=box,
        )
        reason = None
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
            if self.config.recovery.enabled:
                reason = validate_payload(
                    landed, rloss, self.config.recovery, local_norm=self._local_norm
                )
                if reason is not None:
                    got = None
                    outcome = Outcome.POISONED
        self.last_fetch = {
            "peer": peer_index, "outcome": outcome,
            "latency_s": latency_s, "nbytes": nbytes,
        }
        if reason is not None:
            self.last_fetch["poison_reason"] = reason
        with self._stats_lock:
            self.stats["wire_bytes_fetched"] += nbytes
            counts = self.stats["outcomes"]
            counts[outcome] = counts.get(outcome, 0) + 1
        return got

    # -- the round ------------------------------------------------------
    def _weigh(self, got: tuple, clock: float, loss: float) -> float:
        """The interpolation α for a fetched frame, in float32 as the
        reference's."""
        _vec, remote_clock, remote_loss = got
        as_meta = lambda c, l: PeerMeta(
            torch.tensor([c], dtype=torch.float32), torch.tensor([l], dtype=torch.float32)
        )
        return float(self.interp(as_meta(clock, loss), as_meta(remote_clock, remote_loss))[0])

    def _round(self, rep: DeviceReplica, clock: float, loss: float, step: int):
        """Publish, pick the partner, check participation, fetch, guard,
        weigh: ``(remote or None, α, partner)``; None skips the merge."""
        self._publish_replica(rep, clock, loss)
        partner = self.schedule.partner(step, self.me)
        self.last_round = {
            "step": step, "sched_partner": partner, "partner": partner,
            "remapped": False, "outcome": None,
        }
        if partner == self.me or not self.schedule.participates(step, self.me):
            return None, 0.0, partner
        got = self.fetch(partner, step=step, device=rep.dev.device)
        self.last_round["outcome"] = self.last_fetch.get("outcome")
        if got is None:
            return None, 0.0, partner
        return got[0], self._weigh(got, clock, loss), partner

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
