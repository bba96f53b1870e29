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
digest (``DPWM``) and the observability section (``DPWT``), which
``nbytes`` does not count.  A port node and a ``dpwa_tpu`` node gossip with
each other; the fetcher reads the trailers after the payload tolerantly,
dispatching on their magics, and a peer that serves none is the old wire,
not a failure.  The RELAY verb asks a
node to header-probe a third on the asker's behalf (:func:`relay_probe`).

:meth:`TcpTransport.exchange_on_device` merges a replica that lives on the
card: the publish reads back only the wire's bytes and only once per merge
(:class:`~dpwa_tpu_torch.device.replica.DeviceReplica`), the frame lands in
a pinned receive buffer and crosses to the card by an asynchronous copy,
the guard runs there, and the merge is one launch of B2 over ``[1, d]``
(:func:`~dpwa_tpu_torch.device.engine.merge`).
:meth:`TcpTransport.exchange` is the same round for a host vector, merged
on the CPU by B2's plain version.

Five planes run around the round, as the reference runs them by default.
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
come back to the host in one readback.  Flow control
(:mod:`dpwa_tpu_torch.flowctl`): each fetch runs on its peer's adaptive
deadline and is hedged to the schedule's fallback once the peer's latency
quantile lapses (two legs, each landing in its own lease of the receive
ring; only the winner's frame is landed and merged); a soft-``degraded``
partner's rounds are partly shed to the fallback; the Rx server sheds
excess load with the ``DPWB`` busy frame and evicts a trickled request.

The Rx server is the threaded :class:`PeerServer`, or with
``protocol.rx_server: reactor`` the event-loop
:class:`~dpwa_tpu_torch.parallel.reactor.ReactorPeerServer` (one
``selectors`` thread for every connection, the same bytes).  With
``chaos.enabled`` it is the chaos harness's wrapper of either
(:class:`~dpwa_tpu_torch.health.chaos.ChaosPeerServer`,
:class:`~dpwa_tpu_torch.health.chaos.ChaosReactorPeerServer`: seeded wire
and content faults, trickles, partitions) and the fetcher honours its
blocked links; ``health.healthz_port`` serves
:meth:`TcpTransport.health_snapshot` at ``/healthz``
(:mod:`dpwa_tpu_torch.health.endpoint`).

With ``membership.view`` on, the bounded partial view
(:mod:`dpwa_tpu_torch.membership.partial_view`) narrows the planes: the
digest carries a drawn sample of the tracked peers, the per-peer state of
the scoreboard, trust, the estimator and membership is capped at
``state_cap`` (a collapsed-trust peer is never cap-evicted), and remaps,
hedge fallbacks and relays draw from the healthy part of the active view
(:meth:`TcpTransport._view_candidates`).

The codecs (:mod:`dpwa_tpu_torch.ops.quantize`, :mod:`dpwa_tpu_torch.ops.
shard`): ``wire_dtype: int8`` (code 4), ``wire_codec: topk`` with int8 or
float32 values (code 5) and ``shard: {k: >1}`` over any of the encodings
(code 6) publish the reference's frames byte for byte, encoded where the
replica lies (the int8 quantiser is ``csrc/quantize.cu`` on the card, the
top-k encoders' error feedback stays there, and only the body is read back,
at every publish: the int8 dither is keyed on the clock and the encoders
move).  A fetched codec frame is decoded and checked on the host (malformed
is ``corrupt``, never a crash) and lands as it came; its decisions follow
the reference's ``exchange``, the adapters' path: an int8 frame is judged
dequantised on the card, a top-k frame densified against the replica last
published (the guard's zero-energy check and the screen on its support), a
shard frame slice against slice, each codec against trust baselines of its
own (the reference's ``exchange_on_device`` judges some of these on what it
ships alone, which can decide otherwise).  The merges are the reference's
bit for bit: B2's int8-frame form from the codes and scales, the self-lerp
and the support form for top-k, the slice alone for a shard
(:mod:`dpwa_tpu_torch.device.engine`).  :meth:`TcpTransport.wire_snapshot`
tallies the wire.

Beside the lock-step round, the reference's other exchanges, each making
the reference's decisions with its merges on the card; their fetch threads
move bytes only (:meth:`TcpTransport._wire_fetch` into the receive ring),
and landing, the guard, the screen and the merge run on the calling thread
(:meth:`TcpTransport._consume_fetch`, judged against the replica published
in the consuming round).  :meth:`TcpTransport.exchange_overlapped_start`
fetches while the caller computes and merges the pre-step replica in
``finish``.  ``protocol.overlap_prefetch`` runs the double-buffered prefetch
pipeline: round t+1's partner is resolved and its frame streamed while
round t consumes and the caller computes (``wire_snapshot()["overlap"]``
tallies it).  The reference pipelines only its ``exchange``, whose
decisions the port follows (its ``exchange_on_device`` runs the sequential
round even with the flag on); here ``exchange_on_device``, which
``exchange`` and the adapters call, runs the pipeline.
:meth:`TcpTransport.exchange_on_device_fold` is the fan-in round: a frame
from each listed peer, runs of dense frames merged by one launch of B2's
fold form.  ``protocol.async_rounds`` makes the rounds barrier-free
(:mod:`dpwa_tpu_torch.parallel.async_loop`): frames queue per peer and
merge staleness-damped whenever ready, a publish clock at most once
(the ``_async_guard`` dedup).

The ``obs:`` block (:mod:`dpwa_tpu_torch.obs`, every facility off by
default, and then no trailer, no timing call and no obs state): with
``trace`` or ``sketch`` every frame carries the ``DPWT`` trailer, its trace
ID ``"{me}:{clock}"`` and, with ``sketch``, the replica's sketch made where
the replica lies (memoised per publish clock); a fetched trailer's sketch
feeds :attr:`TcpTransport.sketchboard` and its trace ID the round's record.
``trace`` times a round's stages (:class:`~dpwa_tpu_torch.obs.trace.
Tracer`: publish, partner_resolve, wire, join_wait, decode, guard, trust,
merge, and the Rx server's serve spans).  The reference traces the rounds
of its host ``exchange`` only, which its adapters call; the port's
adapters call :meth:`TcpTransport.exchange_on_device`, so that is where
the port's rounds are traced, with the same stages, fields and trace IDs.
``metrics`` serves every plane's families at ``/metrics``, ``incidents`` the
detectors' :class:`~dpwa_tpu_torch.obs.incidents.IncidentPlane` at
``/incidents``, ``recorder`` the :class:`~dpwa_tpu_torch.obs.recorder.
FlightRecorder` at ``/flightdump`` (and on a crash, an incident and a
close).

Not ported yet: the native Rx server.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
import zlib
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dpwa_tpu_torch.config import DEFAULT_MIN_WIRE_MB_PER_S, DpwaConfig, FlowctlConfig
from dpwa_tpu_torch.device import engine
from dpwa_tpu_torch.device.handoff import to_device
from dpwa_tpu_torch.device.replica import DeviceReplica, bf16_wire
from dpwa_tpu_torch.flowctl import AdmissionController, DeadlineEstimator
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.health.scoreboard import Scoreboard
from dpwa_tpu_torch.health.scoreboard import PeerState
from dpwa_tpu_torch.interpolation import PeerMeta, make_interpolation
from dpwa_tpu_torch.membership import digest as _digest
from dpwa_tpu_torch.membership.manager import MembershipManager
from dpwa_tpu_torch.obs import wire as _obs_wire
from dpwa_tpu_torch.ops.quantize import (
    Int8Payload, TopkEncoder, TopkPayload, decode_int8_payload, decode_topk_payload,
    encode_int8_payload, int8_nbytes, topk_k, topk_nbytes,
)
from dpwa_tpu_torch.ops.shard import (
    INNER_NAMES, ShardPayload, decode_shard_payload, encode_shard_payload, shard_bounds,
)
from dpwa_tpu_torch.parallel import ingest
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel.schedules import (
    Schedule, build_schedule, degrade_shed_draw, relay_draw, shard_permutation,
)
from dpwa_tpu_torch.recovery.guard import (
    payload_check_tensors, sparse_norm_tensors, validate_payload,
)
from dpwa_tpu_torch.trust.manager import REJECTED, TrustManager
from dpwa_tpu_torch.trust.screen import payload_sums, payload_sums_sparse, stats_from_sums
from dpwa_tpu_torch.utils.devices import resolve_device

# Flat payload codes: the numpy dtype the bytes are read as, and the torch
# dtype of the decoded vector (bf16 read as int16 and viewed).
_FLAT = {
    pc.PAYLOAD_F32: (np.dtype("<f4"), torch.float32),
    pc.PAYLOAD_F64: (np.dtype("<f8"), torch.float64),
    pc.PAYLOAD_U16: (np.dtype("<u2"), torch.uint16),
    pc.PAYLOAD_BF16: (np.dtype("<i2"), torch.bfloat16),
}

# The payload read's deadline grows by one second per this many bytes
# received (protocol.min_wire_mb_per_s), so a large replica streaming from
# a live peer is never cut by a deadline sized for the rendezvous.
_MIN_WIRE_BANDWIDTH = DEFAULT_MIN_WIRE_MB_PER_S * 1e6
# An advertisement above this reads a probe's worth of bytes before the
# full buffer is leased: a peer that lies about nbytes costs 64 KiB.
_PROBE_THRESHOLD = 1 << 20
_PROBE_BYTES = 1 << 16
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
    payload: torch.Tensor, clock: float, loss: float, digest: Optional[bytes] = None,
    code: Optional[int] = None, obs: Optional[bytes] = None,
) -> tuple:
    """``(header, payload bytes[, digest][, obs])``: the wire frame as the
    segments the server sends, the payload a view of ``payload``'s host
    memory (which the caller must not change while it is served), then the
    membership digest trailer and the ``DPWT`` section when there are
    ones, in that order.  The code follows the payload's dtype (float32,
    float64 or bf16), unless ``code`` names a codec and ``payload`` is its
    encoded body (uint8)."""
    if code is None:
        code = next(c for c, (_, dt) in _FLAT.items() if dt == payload.dtype)
    flat = payload.reshape(-1).contiguous()
    if flat.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    data = flat.numpy().view(np.uint8)
    header = pc.BLOB_HDR.pack(pc.BLOB_MAGIC, 1, code, float(clock), float(loss), data.size)
    segs = (header, data)
    if digest:
        segs += (bytes(digest),)
    if obs:
        segs += (bytes(obs),)
    return segs


def _frame(
    payload: torch.Tensor, clock: float, loss: float, digest: Optional[bytes] = None,
    code: Optional[int] = None, obs: Optional[bytes] = None,
) -> bytes:
    """:func:`_frame_segments` joined: the frame as one byte string."""
    return b"".join(bytes(s) for s in _frame_segments(payload, clock, loss, digest, code, obs))


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


def _busy_frame(retry_hint_ms: int = 0) -> bytes:
    """The ``DPWB`` shed reply: loaded, come back in ``retry_hint_ms``."""
    return pc.BUSY_HDR.pack(pc.BUSY_MAGIC, 1, min(max(int(retry_hint_ms), 0), 0xFFFF))


class PeerServer:
    """The Rx thread: serves this node's latest published frame and state.

    One thread accepts; each connection gets a thread of its own with a
    bounded budget (``flowctl.request_timeout_ms``).  A blob request (a
    header probe too: it reads the header and hangs up) gets the frame
    with its digest trailer, or a close when nothing is published; a STATE
    request one chunk of the published state (a well-formed empty transfer
    when there is none); a RELAY request the report of a header probe of
    the target this server runs for the asker (:meth:`_handle_relay`);
    anything else is closed unanswered.

    With ``flowctl.enabled`` (the default) :attr:`admission` gates the
    server: a connection over the cap or the remote's token bucket, or a
    send past the in-flight-bytes ceiling, is answered with the ``DPWB``
    busy frame, and a request read slower than the minimum ingest rate is
    cut and counted.  :attr:`relay_guard`, when set (the chaos harness
    sets it), is asked whether this node's own link to a relay's target is
    blocked; such a probe reports ``refused``.  :attr:`obs_serve_hook`,
    when set (``obs.trace``), is called ``(trace_id, nbytes, seconds)``
    after each frame served with a trace ID."""

    relay_guard: Optional[Callable[[int], bool]] = None
    obs_serve_hook: Optional[Callable[[str, int, float], None]] = None

    def __init__(self, host: str, port: int, flowctl: Optional[FlowctlConfig] = None):
        self._lock = threading.Lock()
        self._segments: Optional[tuple] = None
        self._payload_nbytes = 0
        self._payload_trace_id: Optional[str] = None
        self._state: Union[bytes, _LazyState, None] = None
        self._state_gen = 0
        self.flowctl = flowctl if flowctl is not None else FlowctlConfig()
        self.admission: Optional[AdmissionController] = (
            AdmissionController(self.flowctl) if self.flowctl.enabled else None
        )
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
        # Traced serves whose span is not yet handed to the hook: close()
        # waits for them, so the tracer closed after it holds every span.
        self._hooked = 0
        self._hooked_done = threading.Condition(self._lock)
        self._thread = threading.Thread(
            target=self._serve, name=f"dpwa-torch-rx:{self.port}", daemon=True
        )
        self._thread.start()

    def publish(
        self, payload: torch.Tensor, clock: float, loss: float, digest: Optional[bytes] = None,
        code: Optional[int] = None, obs: Optional[bytes] = None, trace_id: Optional[str] = None,
    ) -> None:
        """Serve ``payload`` (a host tensor the caller no longer changes;
        with ``code``, a codec's encoded body) with ``clock`` and ``loss``,
        and ``digest`` and ``obs`` as its trailers, from now on; a served
        frame's span is stamped with ``trace_id``."""
        segments = _frame_segments(payload, clock, loss, digest, code, obs)
        nbytes = sum(len(s) for s in segments)
        with self._lock:
            self._segments = segments
            self._payload_nbytes = nbytes
            self._payload_trace_id = trace_id

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
        """The published frame as one byte string."""
        segs = self._segments
        return None if segs is None else b"".join(bytes(s) for s in segs)

    def _serve(self) -> None:
        try:
            self._sock.settimeout(0.2)
        except OSError:
            return
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            host = addr[0] if addr else ""
            if self.admission is not None:
                ok, retry_ms = self.admission.admit(host)
                if not ok:
                    self._shed(conn, retry_ms)
                    continue
            threading.Thread(
                target=self._conn_worker, args=(conn, host),
                name=f"dpwa-torch-rx-conn:{self.port}", daemon=True,
            ).start()

    @staticmethod
    def _shed(conn: socket.socket, retry_ms: int) -> None:
        """The busy reply and a close, without blocking the accept loop."""
        try:
            conn.settimeout(0.5)
            conn.sendall(_busy_frame(retry_ms))
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _conn_worker(self, conn: socket.socket, host: str) -> None:
        try:
            conn.settimeout(self.flowctl.request_timeout_ms / 1000.0)
            self._handle(conn)
        except OSError:
            pass
        finally:
            if self.admission is not None:
                self.admission.release(host)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, conn: socket.socket) -> None:
        """Serve one accepted connection.  Under flowctl the request read
        has a cumulative deadline, extended per byte received at the
        minimum ingest rate: a client trickling its request is evicted."""
        fc = self.flowctl
        deadline, per_byte = None, 0.0
        if fc.enabled:
            deadline = time.monotonic() + fc.request_timeout_ms / 1000.0
            per_byte = 1.0 / fc.min_ingest_bytes_per_s
        body = None
        try:
            req = ingest.recv_exact_into(conn, len(pc.BLOB_REQ), deadline, per_byte)
            if req == pc.STATE_REQ:
                body = ingest.recv_exact_into(conn, pc.STATE_REQ_BODY.size, deadline, per_byte)
        except socket.timeout:
            if self.admission is not None:
                self.admission.note_eviction()
            return
        if req == pc.STATE_REQ:
            self._handle_state(conn, *pc.STATE_REQ_BODY.unpack(body))
        elif req == pc.RELAY_REQ:
            self._handle_relay(conn)
        elif req == pc.BLOB_REQ:
            self._serve_blob(conn)

    def _serve_blob(self, conn: socket.socket) -> None:
        """Send the published frame's segments, under the in-flight-bytes
        ceiling (past it, the busy frame)."""
        with self._lock:
            segments, nbytes = self._segments, self._payload_nbytes
            trace_id = self._payload_trace_id
        if segments is None:
            return
        adm = self.admission
        if adm is not None and not adm.reserve_bytes(nbytes):
            try:
                conn.sendall(_busy_frame(self.flowctl.busy_retry_ms))
            except OSError:
                pass
            return
        hook = self.obs_serve_hook if trace_id is not None else None
        t0 = time.monotonic() if hook is not None else 0.0
        if hook is not None:
            with self._lock:
                self._hooked += 1
        try:
            ingest.sendall_segments(conn, segments)
        finally:
            if adm is not None:
                adm.release_bytes(nbytes)
            if hook is not None:
                try:
                    hook(trace_id, nbytes, time.monotonic() - t0)
                except Exception:  # observability never breaks a serve
                    pass
                with self._lock:
                    self._hooked -= 1
                    self._hooked_done.notify_all()

    def _handle_relay(self, conn: socket.socket) -> None:
        """Serve one relayed header probe: probe the requested target and
        report the classified outcome and the target's publish clock (-1
        when unknown).  The probe's budget is clamped to
        ``MAX_RELAY_TIMEOUT_MS``, so an asker cannot pin this thread."""
        body = ingest.recv_exact_into(conn, pc.RELAY_BODY.size)
        target, port, timeout_ms, hostlen = pc.RELAY_BODY.unpack(body)
        host = (
            str(bytes(ingest.recv_exact_into(conn, hostlen)), "ascii", "replace")
            if hostlen else "127.0.0.1"
        )
        timeout_ms = min(max(int(timeout_ms), 1), pc.MAX_RELAY_TIMEOUT_MS)
        guard = self.relay_guard
        if guard is not None and guard(int(target)):
            outcome, clock = Outcome.REFUSED, None
        else:
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
        with self._lock:
            self._hooked_done.wait_for(lambda: self._hooked == 0, timeout=2.0)


def make_peer_server(host: str, port: int, flowctl: Optional[FlowctlConfig] = None) -> PeerServer:
    """The threaded Rx server, :class:`PeerServer`.  The reference picks
    its native C++ server here where it builds and no Python-only plane is
    on; the port has no native server, so every threaded node serves from
    :class:`PeerServer` (``protocol.rx_server: reactor`` selects
    :class:`~dpwa_tpu_torch.parallel.reactor.ReactorPeerServer` in
    :class:`TcpTransport`)."""
    return PeerServer(host, port, flowctl=flowctl)


_CODEC_DECODERS = {
    pc.PAYLOAD_INT8_CHUNKED: decode_int8_payload,
    pc.PAYLOAD_TOPK_DELTA: decode_topk_payload,
    pc.PAYLOAD_SHARD: decode_shard_payload,
}


def _decode(data: memoryview, code: int):
    """``(vector, owner)``: the flat payload as a CPU tensor viewing
    ``data`` through the numpy array it keeps alive (the owner), or a
    codec's decoded payload (its own owner: an int8 body views ``data``);
    None when the payload is malformed (a flat one of no whole number of
    elements; a codec body its decoder rejects)."""
    if code in _CODEC_DECODERS:
        try:
            payload = _CODEC_DECODERS[code](np.frombuffer(data, dtype=np.uint8))
        except ValueError:
            return None
        return payload, payload
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


def _read_trailers(sock: socket.socket, want_digest: bool = True, want_obs: bool = False,
                   budget_s: float = _TRAILER_BUDGET_S) -> Tuple[Optional[bytes], Optional[bytes]]:
    """``(digest, obs)``: the membership digest and the ``DPWT`` section
    among the trailers after a payload, each None when absent, malformed or
    not wanted.

    Reads a 4-byte magic, dispatches on it and repeats (at most 4
    sections, one of each kind); anything else, or a malformed or missing
    section, ends the read.  The observability section rides after the
    digest, so without ``want_obs`` the read ends at the digest, and it
    ends at the observability section once nothing else is wanted (waiting
    for the server's close would cost a thread switch on its side).  Never
    raises."""
    deadline = time.monotonic() + budget_s
    digest = obs = None
    for _ in range(4):
        magic = _recv_trailing(sock, 4, deadline)
        if magic is None:
            break
        if magic == pc.DIGEST_MAGIC and digest is None:
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
            digest = b"".join((head, body))
            if not want_obs:
                break
        elif magic == pc.OBS_MAGIC and obs is None:
            rest = _recv_trailing(sock, pc.OBS_HDR.size - 4, deadline)
            if rest is None:
                break
            head = b"".join((magic, rest))
            n = _obs_wire.header_sketch_count(head)
            if n is None:
                break
            body = _recv_trailing(sock, _obs_wire.values_size(n), deadline)
            if body is None:
                break
            obs = b"".join((head, body))
            if digest is not None or not want_digest:
                break
        else:
            break
    return (digest if want_digest else None), (obs if want_obs else None)


def fetch_blob_full(
    host: str,
    port: int,
    timeout_ms: int,
    min_bandwidth_bps: float = _MIN_WIRE_BANDWIDTH,
    ring: Optional[ingest.BufferRing] = None,
    lease_box: Optional[list] = None,
    trailer_box: Optional[list] = None,
    sock_box: Optional[list] = None,
    obs_box: Optional[list] = None,
) -> Tuple[Optional[Tuple[torch.Tensor, float, float]], str, float, int]:
    """Fetch a peer's frame: ``(result, outcome, latency_s, payload bytes
    received)``, ``result`` = ``(vector, clock, loss)`` or None.

    ``outcome`` is a :class:`~dpwa_tpu_torch.health.detector.Outcome`:
    ``refused`` (the connect failed), ``timeout`` (the deadline lapsed with
    nothing received), ``slow`` (it lapsed while bytes flowed), ``busy``
    (the peer answered the BUSY shed frame), ``short_read`` (closed or
    reset mid-frame), ``corrupt`` (bad magic, version or code, oversize, a
    payload of no whole elements, a codec body that its decoder rejects),
    ``success``.  A codec frame's result holds its decoded payload
    (:class:`~dpwa_tpu_torch.ops.quantize.Int8Payload`, ``TopkPayload``,
    :class:`~dpwa_tpu_torch.ops.shard.ShardPayload`) in the vector's place.

    ``timeout_ms`` bounds connect, request and header together; the
    payload read earns ``1 / min_bandwidth_bps`` seconds for every byte
    received.  The payload lands in a lease of ``ring`` (a pageable one by
    default) and the vector is a CPU tensor viewing it: with ``lease_box``
    the lease is appended there and the caller releases it once nothing
    reads the vector; without, the lease returns to the ring when the
    vector dies.  With ``trailer_box`` the trailers after a valid payload
    are read too (:func:`_read_trailers`) and the membership digest's
    bytes, or None, appended there; with ``obs_box`` the ``DPWT``
    section's bytes, or None, there.  ``sock_box`` gets the socket once it
    is connected: a hedging caller cancels this fetch from another thread
    by shutting it down (:func:`_cancel`)."""
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
    if sock_box is not None:
        sock_box.append(sock)
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
                magic != pc.BLOB_MAGIC or version != 1
                or (code not in _FLAT and code not in _CODEC_DECODERS)
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
            if trailer_box is not None or obs_box is not None:
                digest, obs = _read_trailers(sock, trailer_box is not None, obs_box is not None)
                if trailer_box is not None:
                    trailer_box.append(digest)
                if obs_box is not None:
                    obs_box.append(obs)
            if code in _CODEC_DECODERS:  # an int8 body lands as it arrived
                ingest.note_rx_frame(0 if code == pc.PAYLOAD_INT8_CHUNKED else 1)
            else:
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


def _cancel(socks: list) -> None:
    """Cancel a fetch leg from another thread: shut its socket down (which
    wakes a recv blocked in the leg at once, where a bare close would leave
    it waiting out its deadline) and close it."""
    for sock in socks:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass


class _Leg:
    """One fetch leg, run inline (:meth:`run`) or on a thread of its own
    (:meth:`start`), its payload landing in a lease of the transport's
    receive ring.  A hedge's loser is :meth:`abandon`-ed: its socket is shut
    down, and its lease goes back to the ring only once the leg's thread is
    done with it (a payload it finished receiving is recycled when its
    vector dies), so a late recv never writes into a buffer another fetch
    holds and no loser's bytes are landed."""

    def __init__(self, transport: "TcpTransport", peer: int, deadline_ms: float):
        self.peer = peer
        self.leases: list = []
        self.socks: list = []
        self.trailers: Optional[list] = [] if transport.membership is not None else None
        self.obs: Optional[list] = [] if transport._obs_wire else None
        self.result: Optional[tuple] = None
        self._abandoned = False
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        host, port = transport._ports[peer]
        self._args = (host, port, int(deadline_ms),
                      transport.config.protocol.min_wire_mb_per_s * 1e6, transport.ring)

    def run(self) -> None:
        host, port, deadline_ms, bandwidth, ring = self._args
        result = fetch_blob_full(
            host, port, deadline_ms, min_bandwidth_bps=bandwidth, ring=ring,
            lease_box=self.leases, trailer_box=self.trailers, sock_box=self.socks,
            obs_box=self.obs,
        )
        with self._lock:
            self.result = result
            if self._abandoned:
                self._recycle()

    def start(self, done: queue.SimpleQueue) -> None:
        """Run on a thread; the leg puts itself on ``done`` when finished (a
        leg that died without a result, which the fetch's classification
        should rule out, is a short read)."""
        def target():
            t0 = time.monotonic()
            try:
                self.run()
            finally:
                with self._lock:
                    if self.result is None:
                        self.result = (None, Outcome.SHORT_READ, time.monotonic() - t0, 0)
                done.put(self)

        self._thread = threading.Thread(target=target, name=f"dpwa-torch-leg:{self.peer}",
                                        daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def finished(self) -> bool:
        return self.result is not None

    @property
    def ok(self) -> bool:
        result = self.result
        return result is not None and result[1] == Outcome.SUCCESS

    def abandon(self) -> None:
        """This leg lost the race: cancel it and give its lease back."""
        _cancel(self.socks)
        with self._lock:
            self._abandoned = True
            if self.result is not None:
                self._recycle()

    def _recycle(self) -> None:
        got = self.result[0]
        while self.leases:
            lease = self.leases.pop()
            lease.recycle(got[0]) if got is not None else lease.release()

    def raw(self, hedged: bool, hedge_winner: Optional[int]) -> tuple:
        """``(peer, got, outcome, latency_s, nbytes, leases, digest, hedged,
        hedge_winner, obs)`` for the consuming half of a fetch."""
        got, outcome, latency_s, nbytes = self.result
        digest = self.trailers[0] if self.trailers else None
        obs = self.obs[0] if self.obs else None
        return (self.peer, got, outcome, latency_s, nbytes, self.leases, digest,
                hedged, hedge_winner, obs)


def _recycle_raw(raw: tuple) -> None:
    """Give a wire fetch's receive-ring leases back: once the frame's host
    vector (or decoded payload) is collected.  Idempotent."""
    got, leases = raw[1], raw[5]
    while leases:
        lease = leases.pop()
        lease.recycle(got[0]) if got is not None else lease.release()


class _Slot:
    """One background wire fetch (a prefetch slot, the overlapped
    exchange's fetch): its thread only moves bytes
    (:meth:`TcpTransport._wire_fetch`, into the receive ring), and the
    training thread :meth:`take`-s the raw result and consumes it.  A
    result nobody takes (a lapsed join, a discontinued pipeline, a close)
    gives its leases back once the thread is done with them."""

    def __init__(self, transport: "TcpTransport", peer: int, step: int):
        self.peer, self.step = peer, step
        self.raw: Optional[tuple] = None
        self.t_start = time.monotonic()
        self.t_end = 0.0  # when the fetch finished (0.0: still streaming)
        self._abandoned = False
        self._lock = threading.Lock()
        self.thread = threading.Thread(target=self._run, args=(transport,),
                                       name=f"dpwa-torch-prefetch:{transport.port}", daemon=True)
        self.thread.start()

    def _run(self, transport: "TcpTransport") -> None:
        raw = transport._wire_fetch(self.peer, None, self.step)
        with self._lock:
            self.t_end = time.monotonic()
            if self._abandoned:
                _recycle_raw(raw)
            else:
                self.raw = raw

    def take(self, timeout_s: float) -> Optional[tuple]:
        """The raw fetch once the thread is done (waiting at most
        ``timeout_s``), or None when the wait lapsed (the slot is then
        abandoned)."""
        self.thread.join(timeout_s)
        with self._lock:
            raw, self.raw = self.raw, None
            if raw is None:
                self._abandoned = True
            return raw

    def abandon(self) -> None:
        with self._lock:
            self._abandoned = True
            raw, self.raw = self.raw, None
        if raw is not None:
            _recycle_raw(raw)


class _Landed:
    """A fetched frame on the merge's device: ``merge``, what the engine
    merges (a flat tensor or a codec payload); ``dense``, the sender's
    estimate at the replica's length that the guard checks (a top-k or
    shard frame densified against the replica last published); ``sparse``,
    ``(values, local_selected)`` of what a top-k or shard frame ships, whose
    norms the zero-energy check compares; and what the trust screen judges:
    the slices of a shard frame (``trust_local``, ``trust_remote``), a
    top-k frame's support (``trust_sparse``), the codec's baseline family
    (``trust_codec``) and the shard (``shard``).  ``codec`` is the frame's
    codec as ``last_fetch`` reports it (None for a dense or int8 frame)."""

    __slots__ = ("merge", "dense", "sparse", "codec", "trust_codec", "trust_local",
                 "trust_remote", "trust_sparse", "shard")

    def __init__(self, merge, dense, sparse=None, codec=None, trust_codec=None,
                 trust_local=None, trust_remote=None, trust_sparse=None, shard=None):
        self.merge, self.dense, self.sparse, self.codec = merge, dense, sparse, codec
        self.trust_codec, self.trust_local, self.trust_remote = trust_codec, trust_local, trust_remote
        self.trust_sparse, self.shard = trust_sparse, shard

    def vector(self) -> torch.Tensor:
        """The sender's estimate as a flat vector (dequantised on demand)."""
        if self.dense is None:
            self.dense = self.merge.dequantize()
        return self.dense


def _flat(vec: torch.Tensor) -> torch.Tensor:
    """``vec`` itself when it is flat (the replica is recognised by
    identity), else its flat view."""
    return vec if vec.dim() == 1 else vec.reshape(-1)


class _OverlappedExchange:
    """An overlapped gossip round in flight (:meth:`TcpTransport.
    exchange_overlapped_start`): the partner's frame streams on a background
    slot while the caller computes its local step.

    ``finish(pre, update)`` joins the fetch, consumes the frame on the
    calling thread and returns ``(merge(pre, remote) + update, α,
    partner)``, or ``(pre + update, 0.0, partner)`` on a skipped round (a
    self-pair, a round the schedule masks, a failed or lapsed fetch): the
    algebra of the stacked step's ``overlap=True`` (merge the pre-update
    replicas, land the local update on the merged result).  The membership
    round ends in ``finish``."""

    def __init__(self, transport: "TcpTransport", clock: float, loss: float, step: int,
                 expected_nbytes: int = 0):
        self._t = transport
        self._clock, self._loss, self._step = clock, loss, step
        # The partner's frame is the size of ours on the wire: it sizes the
        # join backstop as the fetch's own deadline grows with the bytes.
        self._expected_nbytes = expected_nbytes
        self.sched_partner, self.partner, self.remapped = transport._resolve_partner(step)
        # Participation stays keyed on the scheduled pairing (a remap moves
        # only the fetch).
        self._participates = (
            self.partner != transport.me and transport.schedule.participates(step, transport.me)
        )
        self._slot: Optional[_Slot] = None

    def start(self) -> None:
        if self._participates:
            self._slot = _Slot(self._t, self.partner, self._step)

    def finish(self, pre_vec, update=None):
        t = self._t
        as_numpy = isinstance(pre_vec, np.ndarray)
        pre = _flat(torch.from_numpy(np.ascontiguousarray(pre_vec, dtype=np.float32))
                    if as_numpy else pre_vec)
        got = None
        try:
            if self._slot is not None:
                raw = self._slot.take(t._join_backstop_s(self._expected_nbytes))
                if raw is not None:
                    got = t._consume_fetch(raw, self._step, pre.device)
                    del raw
        finally:
            t._membership_end_round(self._step)
        if got is None:
            merged, alpha = pre_vec, 0.0
            t._count_round(())
        else:
            alpha = t._weigh(got, self._clock, self._loss)
            merged = engine.merge(pre, got[0].merge, alpha)
            t._count_round(((t.last_fetch["peer"], got[1]),))
            if as_numpy:
                merged = merged.numpy()
        if update is not None:
            merged = merged + update
        return merged, alpha, self.partner


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
    verdict.  The ``obs:`` block's facilities are :attr:`tracer`,
    :attr:`sketchboard`, :attr:`metrics_registry`, :attr:`incidents` and
    :attr:`flight`, each None when off."""

    def __init__(self, config: DpwaConfig, name: str, device=None):
        self.config = config
        self.me = config.node_index(name)
        self.device = resolve_device(device)
        # Hierarchical gossip: a topology: block swaps in the two-level pool
        # (intra-island slots for everyone, wide-area slots for the island
        # leaders only; a self-pair does not fetch).  No block: the flat pool.
        self.topology = None
        if config.topology.enabled:
            from dpwa_tpu_torch.hier.schedule import build_hier_schedule
            from dpwa_tpu_torch.hier.topology import Topology

            self.topology = Topology.from_config(config)
            self.schedule: Schedule = build_hier_schedule(config)
        else:
            self.schedule = build_schedule(config)
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
        proto = config.protocol
        # The codecs: the replica's publish is encoded on its device and only
        # the body's bytes are read back.  The top-k encoders' error feedback
        # lives there too; a sharded wire keeps one encoder per shard.
        self._wire_topk = proto.wire_codec == "topk"
        self._shard_k = int(config.shard.k)
        self._shard_on = config.shard.enabled
        self._codec = self._shard_on or self._wire_topk or self.wire == "int8"
        self._topk_encoder = (TopkEncoder(proto.topk_fraction, proto.topk_values)
                              if self._wire_topk and not self._shard_on else None)
        self._shard_topk_encoders: dict = {}
        self._shard_perm: Optional[tuple] = None  # (epoch, permutation)
        self._wire_tally = {"frames": 0, "wire_bytes": 0, "dense_bytes": 0}
        self._shard_tally: dict = {}
        self.ring = ingest.BufferRing(pinned=self.device.type == "cuda")
        self._dev_replica: Optional[DeviceReplica] = None
        self._local_norm: Optional[float] = None
        self._init_obs(config)
        spec = config.nodes[self.me]
        # Fetcher-side flow control: adaptive deadlines and hedging (None:
        # every fetch runs on protocol.timeout_ms).
        self._estimator: Optional[DeadlineEstimator] = (
            DeadlineEstimator(config.flowctl, timeout_ms=config.protocol.timeout_ms)
            if config.flowctl.enabled else None
        )
        # Chaos wraps the Rx server, threaded or reactor; its engine also
        # blocks the links its partitions cut on this fetching side.
        self._chaos_engine = None
        reactor = proto.rx_server == "reactor"
        if config.chaos.enabled:
            from dpwa_tpu_torch.health.chaos import (
                ChaosEngine, ChaosPeerServer, ChaosReactorPeerServer,
            )

            self._chaos_engine = ChaosEngine(config.chaos, self.me)
            server_cls = ChaosReactorPeerServer if reactor else ChaosPeerServer
            self.server = server_cls(spec.host, spec.port, self._chaos_engine,
                                     flowctl=config.flowctl)
        elif reactor:
            from dpwa_tpu_torch.parallel.reactor import ReactorPeerServer

            self.server = ReactorPeerServer(spec.host, spec.port, flowctl=config.flowctl)
        else:
            self.server = make_peer_server(spec.host, spec.port, flowctl=config.flowctl)
        if self.tracer is not None and hasattr(self.server, "obs_serve_hook"):
            # Serve spans: the threaded and the reactor servers time their
            # sends (the chaos harness's threaded wrapper has no hook, so
            # its nodes trace the fetching side only, as the reference's).
            self.server.obs_serve_hook = self.tracer.note_serve
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
            leader_board = None
            if self.topology is not None:
                # Seeded by leader_seed, the draw the hier pool's term-0
                # wide-area slots were built from.
                from dpwa_tpu_torch.hier.leader import LeaderBoard

                leader_board = LeaderBoard(self.topology, seed=config.topology.leader_seed)
            self.membership = MembershipManager(
                n, self.me, self.scoreboard, config.membership, seed=self.schedule.seed,
                topology=self.topology, leader_board=leader_board,
            )
            if self.trust is not None:
                self.membership.add_evict_listener(self.trust.evict_peer)
            if self._estimator is not None:
                self.membership.add_evict_listener(self._estimator.evict_peer)
            if self.membership.partial is not None and self.trust is not None:
                # The cap never drops a collapsed-trust verdict, and trust's
                # snapshot lists the tracked peers only.
                self.membership.add_cap_protector(self.trust.is_collapsed)
                self.trust.enable_capped_snapshots()
        if self.trust is not None and self.scoreboard is not None:
            # Collapsed trust feeds the scoreboard as untrusted probes.
            self.trust.attach_scoreboard(self.scoreboard)
        self.last_digest_nbytes = 0
        # The clock last published (the probe's freshness check reads it)
        # and the re-sync advice pending for the adapter.
        self._last_clock = 0.0
        self.resync_advice: Optional[dict] = None
        self._stats_lock = threading.Lock()
        self.stats = {
            "frames_published": 0, "wire_bytes_published": 0,
            "rounds": 0, "merged": 0, "wire_bytes_fetched": 0,
            "outcomes": {}, "verdicts": {}, "probes": 0, "relay_probes": 0,
            # digest version -> fetched frames that carried one
            "digest_versions": {},
            # peer -> [merged rounds, the newest publish clock merged]
            "merged_from": {},
        }
        self._round_clock: Optional[float] = None
        self.last_fetch: dict = {}
        self.last_round: dict = {}
        # The double-buffered prefetch pipeline (protocol.overlap_prefetch):
        # round t+1's slot, {step, sched, partner, remapped, expected_nbytes,
        # slot (None when that round does not fetch)}, and the overlap tally.
        self._prefetch_on = proto.overlap_prefetch
        self._prefetch_slot: Optional[dict] = None
        self._pipe_last_entry: Optional[float] = None
        self._overlap = {
            "rounds": 0, "prefetched": 0, "straddled": 0,
            "fetch_s": 0.0, "join_wait_s": 0.0, "inflight_s": 0.0, "round_s": 0.0,
        }
        # Barrier-free rounds (protocol.async_rounds): the engine wraps this
        # transport and arms _async_guard, the highest publish clock merged
        # per peer, which _consume_fetch holds every delivery to.  Both stay
        # None with the block off: the lock-step paths take no async branch.
        self.async_engine = None
        self._async_guard: Optional[dict] = None
        self.healthz = None
        if config.health.enabled and config.health.healthz_port is not None:
            from dpwa_tpu_torch.health.endpoint import HealthzServer

            routes = {}
            if self.incidents is not None:
                routes["/incidents"] = self.incidents.snapshot
            if self.flight is not None:
                routes["/flightdump"] = self._flight_dump_route
            self.healthz = HealthzServer(
                self.health_snapshot, spec.host, config.health.healthz_port,
                metrics_fn=(self.metrics_registry.render if self.metrics_registry is not None
                            else None),
                extra_routes=routes or None,
            )
        if proto.async_rounds.enabled:
            from dpwa_tpu_torch.parallel.async_loop import AsyncExchangeEngine

            AsyncExchangeEngine(self)
        if self.metrics_registry is not None:
            # Last: the collectors read the planes, which must all exist.
            self._register_metrics(self.metrics_registry)

    def _init_obs(self, config: DpwaConfig) -> None:
        """The ``obs:`` block's facilities, each None when off (the round
        then takes no obs branch and makes no timing call, and frames are
        those of a build without the plane)."""
        obs = config.obs
        self.tracer = None
        if obs.trace:
            from dpwa_tpu_torch.obs.trace import Tracer

            self.tracer = Tracer(self.me, every=obs.trace_every, path=obs.trace_path,
                                 max_records=obs.trace_max_records)
        self.sketchboard = None
        if obs.sketch:
            from dpwa_tpu_torch.obs.sketch import SketchBoard

            self.sketchboard = SketchBoard(self.me, k=obs.sketch_k)
        # A published DPWT section, and the trailer read of a fetch, follow
        # either facility (the trace ID is free once the section exists).
        self._obs_wire = obs.trace or obs.sketch
        self._trace_id: Optional[str] = None
        self._obs_trailer_cache: Optional[Tuple[int, bytes]] = None
        # A traced round's merge on the card: its (start, end) CUDA events.
        self._merge_events: Optional[tuple] = None
        self.metrics_registry = None
        if obs.metrics:
            from dpwa_tpu_torch.obs.prometheus import MetricsRegistry

            self.metrics_registry = MetricsRegistry()
        self.incidents = None
        if obs.incidents:
            from dpwa_tpu_torch.obs.incidents import IncidentPlane

            self.incidents = IncidentPlane(self.me, len(config.nodes), obs,
                                           topology=self.topology)
        self.flight = None
        if obs.recorder:
            from dpwa_tpu_torch.obs.recorder import FlightRecorder

            self.flight = FlightRecorder(self.me, rounds=obs.recorder_rounds,
                                         path=obs.recorder_path)
            self.flight.arm_crash_dump()
        # With the incident plane or the recorder on, the round boundary
        # drains the membership and trust events (the detectors see them
        # the round they happen) into these buffers, which pop_*_events read.
        self._membership_event_buf: list = []
        self._trust_event_buf: list = []
        self._obs_round_entry_t: Optional[float] = None

    @property
    def port(self) -> int:
        return self.server.port

    def set_peer_port(self, index: int, port: int) -> None:
        """Point peer ``index`` at another port (tests bind to port 0)."""
        host, _ = self._ports[index]
        self._ports[index] = (host, port)

    # -- publish --------------------------------------------------------
    def _serve(self, payload: torch.Tensor, clock: float, loss: float, dense_bytes: int,
               code: Optional[int] = None, shard: Optional[int] = None,
               obs: Optional[bytes] = None) -> None:
        nbytes = payload.numel() * payload.element_size()
        with self._stats_lock:
            self.stats["frames_published"] += 1
            self.stats["wire_bytes_published"] += nbytes
            tally = self._wire_tally
            tally["frames"] += 1
            tally["wire_bytes"] += nbytes
            tally["dense_bytes"] += dense_bytes
            if shard is not None:
                st = self._shard_tally.setdefault(shard, {"frames": 0, "wire_bytes": 0})
                st["frames"] += 1
                st["wire_bytes"] += nbytes
        # The epidemic piggyback: this node's view rides every frame.
        digest = self.membership.encode(int(clock)) if self.membership is not None else None
        if digest is not None:
            self.last_digest_nbytes = len(digest)
        if obs is None:
            self.server.publish(payload, clock, loss, digest, code)
        else:
            self.server.publish(payload, clock, loss, digest, code, obs=obs,
                                trace_id=self._trace_id)

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
        tr = self.tracer
        if tr is None:
            self._publish(rep, clock, loss)
            return
        t0 = time.monotonic()
        try:
            self._publish(rep, clock, loss)
        finally:
            tr.mark("publish", time.monotonic() - t0)
            tr.set(trace_id=self._trace_id)

    def _make_obs_trailer(self, rep: DeviceReplica, clock: float) -> bytes:
        """The ``DPWT`` section of this publish: the trace ID and, with the
        sketch on (every ``sketch_every`` clocks), the sketch of the whole
        replica (a top-k or shard frame carries the whole replica's too),
        made on its device with ``k`` floats read back; ``norm_est`` is the
        sketch's own norm.  One section a publish clock: a republish under
        the same clock reuses it."""
        seq = int(clock) & 0xFFFFFFFF
        self._trace_id = f"{self.me}:{seq}"
        cached = self._obs_trailer_cache
        if cached is not None and cached[0] == seq:
            return cached[1]
        sketch, norm = None, 0.0
        board = self.sketchboard
        if board is not None and int(clock) % self.config.obs.sketch_every == 0:
            from dpwa_tpu_torch.obs.sketch import replica_sketch

            sketch = replica_sketch(rep.dev, self.schedule.seed, board.k)
            norm = float(np.dot(sketch, sketch)) ** 0.5
            board.note_local(seq, sketch)
        blob = _obs_wire.encode_obs(self.me, seq, norm, sketch)
        self._obs_trailer_cache = (seq, blob)
        return blob

    def _publish(self, rep: DeviceReplica, clock: float, loss: float) -> None:
        self._last_clock = float(clock)
        rec = self.config.recovery
        zero_energy = rec.enabled and rec.min_param_norm_ratio > 0.0
        if self.trust is not None or self._wire_topk or self._shard_on or zero_energy:
            # What a fetched frame is judged against, and what a top-k or
            # shard frame densifies against: the replica just published.
            self._local_vec = rep.dev
        dense_bytes = 4 * rep.dev.numel()
        obs = self._make_obs_trailer(rep, clock) if self._obs_wire else None
        if self._codec:
            code, shard = self._codec_of(clock)
            body = rep.encoded(lambda v: self.codec_body(v, clock)[0])
            self._serve(body, clock, loss, dense_bytes, code, shard, obs)
        else:
            self._serve(rep.payload(self.wire), clock, loss, dense_bytes, obs=obs)
        if zero_energy:
            self._local_norm = rep.norm()

    def _codec_of(self, clock: float) -> Tuple[int, Optional[int]]:
        """The payload code of this wire's frames and the shard of
        ``clock`` (None unsharded)."""
        if self._shard_on:
            return pc.PAYLOAD_SHARD, self._shard_index(int(clock), self._shard_k)
        return (pc.PAYLOAD_TOPK_DELTA if self._wire_topk else pc.PAYLOAD_INT8_CHUNKED), None

    def codec_body(self, vec: torch.Tensor, clock: float) -> Tuple[torch.Tensor, int]:
        """The codec frame's body of the replica ``vec`` published at
        ``clock``, encoded where ``vec`` lies (uint8), and its payload code:
        int8-chunked, top-k (this node's encoder, whose error feedback it
        moves) or, sharded, the slice of ``int(clock)``'s shard encoded as
        the wire says (top-k with the shard's own encoder; int8 scale
        tables restarting at the slice)."""
        seed, proto = self.schedule.seed, self.config.protocol
        code, shard = self._codec_of(clock)
        if shard is None:
            if self._wire_topk:
                return self._topk_encoder.encode(vec, seed, clock, self.me), code
            return encode_int8_payload(vec, seed, clock, self.me), code
        d, k = vec.numel(), self._shard_k
        lo, hi = shard_bounds(d, k, shard)
        sl = vec[lo:hi]
        if self._wire_topk:
            enc = self._shard_topk_encoders.get(shard)
            if enc is None:
                enc = self._shard_topk_encoders[shard] = TopkEncoder(
                    proto.topk_fraction, proto.topk_values)
            inner, inner_code = enc.encode(sl, seed, clock, self.me), pc.PAYLOAD_TOPK_DELTA
        elif self.wire == "int8":
            inner, inner_code = encode_int8_payload(sl, seed, clock, self.me), pc.PAYLOAD_INT8_CHUNKED
        elif self.wire == "bf16":
            inner, inner_code = bf16_wire(sl), pc.PAYLOAD_BF16
        else:
            inner, inner_code = sl, pc.PAYLOAD_F32
        return encode_shard_payload(inner, d, k, shard, inner_code), code

    def _shard_index(self, step: int, k: int) -> int:
        """The shard of publish clock ``step`` (``shard_draw``), one
        permutation drawn per epoch of k rounds."""
        epoch, pos = divmod(int(step), k)
        memo = self._shard_perm
        if memo is None or memo[0] != epoch:
            memo = self._shard_perm = (epoch, shard_permutation(self.schedule.seed, epoch, k))
        return int(memo[1][pos])

    # -- fetch ----------------------------------------------------------
    def fetch(self, peer_index: int, timeout_ms: Optional[int] = None,
              step: Optional[int] = None, device=None, landed: bool = False):
        """Fetch, land, guard and screen ``peer_index``'s frame: ``(vector,
        clock, loss)`` with the vector on ``device`` (the CPU by default;
        float32, or bf16 as the wire carried it; a codec frame's vector is
        the sender's estimate: dequantised, or densified against the replica
        last published), or None if the fetch failed, the guard refused it
        (``poisoned``) or the trust screen rejected it (``untrusted``).
        Under flowctl the fetch runs on the peer's adaptive deadline and may
        be hedged to a fallback (:meth:`_hedged_fetch`); everything after
        the wire is charged to the peer whose frame won.  The frame's digest
        is merged into the membership view; a failure that would quarantine
        the peer first asks relays to probe it.  :attr:`last_fetch` holds
        the outcome, which the scoreboard and the estimator record against
        round ``step``.  With ``landed`` the first element is the landed
        frame itself (what the round merges: a codec frame's payload)."""
        got = self._fetch_landed(peer_index, timeout_ms, step, device)
        if got is None or landed:
            return got
        return got[0].vector(), got[1], got[2]

    def _land(self, remote, device) -> Optional["_Landed"]:
        """A fetched frame on ``device``, with what the guard and the screen
        judge (the consume leg of the reference's ``exchange``): None when a
        top-k or shard frame cannot be read against the replica last
        published (none, or another length: ``corrupt``)."""
        if isinstance(remote, torch.Tensor):
            if remote.dtype not in (torch.float32, torch.bfloat16):
                remote = remote.to(torch.float32)  # an f64 or u16 frame: one copy
            landed, event = to_device(remote, device)
            if event is not None:
                event.synchronize()
            return _Landed(landed, landed)
        lv = self._local_vec
        if isinstance(remote, Int8Payload):
            payload = remote.to(device)
            # The guard and the screen judge the dense remote; the merge
            # reads the codes and scales.
            judged = self.config.recovery.enabled or self.trust is not None
            return _Landed(payload, payload.dequantize() if judged else None)
        if isinstance(remote, ShardPayload):
            if lv is None or lv.numel() != remote.d:
                return None
            payload = remote.to(device)
            lo, hi = payload.bounds
            local_slice = lv[lo:hi]
            est = payload.slice_estimate(local_slice)
            dense = lv.clone()
            dense[lo:hi] = est
            inner = payload.inner
            if isinstance(inner, TopkPayload):
                trust_codec = "topk"
                local_sel = local_slice[inner.indices]
                sparse, trust_sparse = (inner.values, local_sel), (inner.indices, inner.values)
            else:
                # Zero energy on the slice shipped: the densified vector
                # shares k−1 slices with the local replica.
                trust_codec = INNER_NAMES[payload.inner_code]
                sparse, trust_sparse = (est, local_slice), None
            return _Landed(payload, dense, sparse=sparse, codec=f"shard+{trust_codec}",
                           trust_codec=trust_codec, trust_local=local_slice, trust_remote=est,
                           trust_sparse=trust_sparse, shard=payload.shard_idx)
        if lv is None or lv.numel() != remote.n:
            return None
        payload = remote.to(device)
        local_sel = lv[payload.indices]
        return _Landed(payload, payload.densify(lv), sparse=(payload.values, local_sel),
                       codec="topk", trust_sparse=(payload.indices, payload.values))

    def _fetch_landed(self, peer_index: int, timeout_ms: Optional[int], step: Optional[int],
                      device) -> Optional[tuple]:
        """:meth:`fetch`'s round: ``(landed frame, clock, loss)`` or None."""
        device = torch.device("cpu") if device is None else torch.device(device)
        return self._consume_fetch(self._wire_fetch(peer_index, timeout_ms, step), step, device)

    def _consume_fetch(self, raw: tuple, step: Optional[int], device) -> Optional[tuple]:
        """The consume half of a fetch, on the training thread: land the
        frame of :meth:`_wire_fetch`'s ``raw`` on ``device``, guard it,
        screen it and record it against round ``step``, judged against the
        replica published in this round (a prefetched frame whose fetch
        straddled a publish is judged against the newer replica): ``(landed
        frame, clock, loss)`` or None.  Under barrier-free rounds a publish
        clock at or below the peer's last merged one is dropped first as
        ``stale``, and a frame's clock is latched only once every screen has
        passed.  The receive-ring leases go back on every exit."""
        try:
            return self._consume(raw, step, torch.device(device))
        finally:
            _recycle_raw(raw)

    def _consume(self, raw: tuple, step: Optional[int], device) -> Optional[tuple]:
        (peer_index, got, outcome, latency_s, nbytes, _leases, digest,
         hedged, hedge_winner) = raw[:9]
        obs = raw[9] if len(raw) > 9 else None  # a fetch without the obs read
        tr = self.tracer
        timing = tr is not None and tr.active
        if timing:
            # The leg's own streaming time (under the pipeline it ran a round
            # earlier; join_wait is what the caller waited for it).
            tr.mark("wire", latency_s)
        if obs is not None and (timing or self.sketchboard is not None):
            frame = _obs_wire.decode_obs(obs)
            if frame is not None:
                if timing:
                    tr.set(remote_trace_id=frame.trace_id)
                if self.sketchboard is not None and frame.sketch is not None:
                    self.sketchboard.note_remote(frame.origin, frame.seq, frame.sketch,
                                                 round=step)
        guard = self._async_guard
        if guard is not None and got is not None and float(got[1]) <= guard.get(
                peer_index, float("-inf")):
            # This peer's publish clock (or a newer one) already merged: a
            # second delivery (a prefetch slot, the async queue, a hedge leg)
            # is dropped before any landing work.
            got = None
            outcome = Outcome.STALE
        reason = trust_info = codec = None
        self._pending_trust_scale = 1.0
        if got is not None:
            remote, rclock, rloss = got
            got = None
            # A codec frame's decoding is the decode stage (a dense frame's
            # landing is in no stage, as the reference's device merge
            # engine lands inside its merge).
            decoding = timing and not isinstance(remote, torch.Tensor)
            t_stage = time.monotonic() if decoding else 0.0
            landed = self._land(remote, device)
            del remote
            if decoding:
                tr.mark("decode", time.monotonic() - t_stage)
            if landed is None:
                outcome = Outcome.CORRUPT
            else:
                codec = landed.codec
                got = (landed, rclock, rloss)
                t_stage = time.monotonic() if timing else 0.0
                reason, sums = self._judge(peer_index, landed, rloss)
                if timing:
                    # One readback serves the guard and the screen's sums:
                    # the guard's span (the screen's without recovery).
                    tr.mark("guard" if self.config.recovery.enabled else "trust",
                            time.monotonic() - t_stage)
            if reason is not None:
                got = None
                outcome = Outcome.POISONED
            elif got is not None and self.trust is not None and self._local_vec is not None:
                # The screen judges what would merge (a top-k frame on its
                # support, a shard frame slice against slice); a rejection
                # is the untrusted outcome, recorded as poisoned is (and,
                # like it, never gated behind relays).
                t_stage = time.monotonic() if timing else 0.0
                verdict, scale, tstats = self.trust.screen(
                    peer_index,
                    landed.trust_remote if landed.trust_remote is not None else landed.dense,
                    rclock,
                    landed.trust_local if landed.trust_local is not None else self._local_vec,
                    round=step, stats=None if sums is None else stats_from_sums(sums),
                    codec=landed.trust_codec or codec or "dense", sparse=landed.trust_sparse,
                    shard=landed.shard,
                )
                if timing:
                    tr.mark("trust", time.monotonic() - t_stage)
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
        if codec is not None:
            self.last_fetch["codec"] = codec
        if hedged:
            self.last_fetch["hedged"] = True
            self.last_fetch["hedge_winner"] = hedge_winner
        if reason is not None:
            self.last_fetch["poison_reason"] = reason
        if trust_info is not None:
            self.last_fetch["trust"] = trust_info
        with self._stats_lock:
            self.stats["wire_bytes_fetched"] += nbytes
            counts = self.stats["outcomes"]
            counts[outcome] = counts.get(outcome, 0) + 1
            if digest:
                versions = self.stats["digest_versions"]
                versions[digest[4]] = versions.get(digest[4], 0) + 1
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
        if self._estimator is not None:
            # The final outcome, after the guard and the screen: a poisoned
            # success must not teach the deadline that the peer is fast.
            self._estimator.observe(peer_index, outcome, latency_s=latency_s, nbytes=nbytes)
        if guard is not None and got is not None and got[1] > guard.get(peer_index, float("-inf")):
            guard[peer_index] = float(got[1])
        return got

    def _wire_fetch(self, peer: int, timeout_ms: Optional[int] = None,
                    step: Optional[int] = None) -> tuple:
        """The wire half of a fetch, which moves bytes only (a prefetch or
        async slot runs it on its own thread): ``(winner, got, outcome,
        latency_s, nbytes, leases, digest, hedged, hedge_winner, obs)``, the
        frame's host vector (or decoded payload) viewing the ``leases`` of
        the receive ring until :meth:`_consume_fetch` gives them back.  A
        link the chaos harness blocks is refused without a socket."""
        if timeout_ms is None:
            timeout_ms = self.config.protocol.timeout_ms
        if self._link_blocked(peer):
            return peer, None, Outcome.REFUSED, 0.0, 0, [], None, False, None, None
        if self._estimator is not None:
            return self._hedged_fetch(peer, step, timeout_ms)
        leg = _Leg(self, peer, timeout_ms)
        leg.run()
        return leg.raw(False, None)

    def _hedged_fetch(self, peer: int, step: Optional[int], timeout_ms: int) -> tuple:
        """A fetch on the estimator's deadline for ``peer`` (``timeout_ms``
        while it is cold) with at most one hedge: if the un-margined
        quantile lapses with the fetch still in flight and a healthy
        fallback exists, a second leg fetches the fallback and the first
        success wins (the primary on a tie, or when both fail).  Only the
        loser is recorded here; the winner goes through :meth:`fetch`'s
        tail."""
        est = self._estimator
        deadline_ms = est.deadline_ms(peer) if est.warm(peer) else float(timeout_ms)
        launch_ms = est.hedge_launch_ms(peer) if self.config.flowctl.hedge else None
        primary = _Leg(self, peer, deadline_ms)
        if launch_ms is None or len(self.config.nodes) <= 2:
            # No hedge: a cold estimator, or no third peer to fall back on.
            primary.run()
            return primary.raw(False, None)
        t0 = time.monotonic()
        done: queue.SimpleQueue = queue.SimpleQueue()
        primary.start(done)
        primary.join(launch_ms / 1000.0)
        fallback = None
        if not primary.finished:
            fallback = self._hedge_fallback(peer, int(step) if step is not None else 0)
        if fallback is None:
            primary.join()
            return primary.raw(False, None)
        est.note_hedge(peer)
        hedge = _Leg(self, fallback, est.deadline_ms(fallback))
        hedge.start(done)
        # Both legs end on their own deadlines, so this wait is bounded.
        while not (done.get().ok or (primary.finished and hedge.finished)):
            pass
        elapsed = time.monotonic() - t0
        if primary.ok or not hedge.ok:
            hedge_done = hedge.finished
            hedge.abandon()
            if hedge_done:
                self._record_loser(fallback, hedge.result, False, 0.0, step)
            return primary.raw(True, peer)
        est.note_hedge_win(peer)
        primary_done = primary.finished
        primary.abandon()
        # A leg cancelled by our own close is not evidence against its
        # peer: it records the soft slow outcome.
        self._record_loser(peer, primary.result if primary_done else None,
                           not primary_done, elapsed, step)
        return hedge.raw(True, fallback)

    def _view_candidates(self) -> Optional[List[int]]:
        """The sorted active view with ``membership.view`` on, else None
        (draws range over all of ``nodes:``)."""
        return None if self.membership is None else self.membership.partner_candidates()

    def _remap(self, step: int, sched: int) -> int:
        """The healthy fallback of a remapped round: over the whole ring's
        healthy mask, or with the partial view on over the active view
        (eligibility read for those peers only)."""
        view = self._view_candidates()
        healthy = (self.scoreboard.healthy_mask(step) if view is None
                   else self.scoreboard.healthy_map(view, step))
        return self.schedule.remap_partner(step, self.me, sched, healthy, view)

    def _hedge_fallback(self, peer: int, step: int) -> Optional[int]:
        """The hedge's target: the schedule's fallback draw over the healthy
        peers (the draw a quarantine remap makes this round; of the active
        view with the partial view on), or None when there is no other
        healthy, reachable peer."""
        if self.scoreboard is not None:
            fallback = self._remap(step, peer)
        else:
            fallback = self.schedule.remap_partner(step, self.me, peer,
                                                   [True] * len(self.config.nodes))
        if fallback in (self.me, peer) or self._link_blocked(fallback):
            return None
        return int(fallback)

    def _record_loser(self, peer: int, result: Optional[tuple], cancelled: bool,
                      latency_s: float, step: Optional[int]) -> None:
        """Feed a hedge's losing leg to the scoreboard and the estimator: its
        own outcome when it finished, ``slow`` when we cancelled it."""
        if cancelled or result is None:
            outcome, lat, nbytes = Outcome.SLOW, latency_s, 0
        else:
            _got, outcome, lat, nbytes = result
        if self.scoreboard is not None:
            self.scoreboard.record(peer, outcome, latency_s=lat, nbytes=nbytes, round=step)
        self._estimator.observe(peer, outcome, latency_s=lat, nbytes=nbytes)

    def _link_blocked(self, peer: int) -> bool:
        """Whether the chaos harness blocks this node's link to ``peer`` at
        the round of the clock last published (False without chaos)."""
        if self._chaos_engine is None:
            return False
        return self._chaos_engine.link_blocked(int(self._last_clock), self.me, peer)

    def _judge(self, peer_index: int, landed: "_Landed", rloss: float):
        """The guard's verdict on a landed frame and the trust screen's five
        sums, read back together: ``(poison reason or None, sums or
        None)``.  The sums are computed only when the screen will run on
        vectors of one length (else it rejects on its own): a top-k frame's
        over its support, a shard frame's over its slice."""
        local = self._local_vec
        sums = None
        if self.trust is not None and local is not None:
            t_local = landed.trust_local if landed.trust_local is not None else local
            t_remote = landed.trust_remote if landed.trust_remote is not None else landed.dense
            if landed.trust_sparse is not None:
                sums = payload_sums_sparse(t_local, *landed.trust_sparse)
            elif t_remote.numel() == t_local.numel():
                sums = payload_sums(t_local, t_remote.to(t_local.device),
                                    self.trust.leaf_starts(t_local.numel()))
        if not self.config.recovery.enabled:
            return None, (None if sums is None else sums.tolist())
        checks = payload_check_tensors(landed.dense)
        if landed.sparse is not None:
            checks = torch.cat([checks, sparse_norm_tensors(*landed.sparse).to(checks.device)])
        n_guard = checks.numel()
        if sums is not None:
            checks = torch.cat([checks, sums.to(device=checks.device, dtype=torch.float64)])
        values = checks.tolist()
        reason = validate_payload(
            landed.dense, rloss, self.config.recovery, local_norm=self._local_norm,
            checks=values[:2], sparse=values[2:4] if landed.sparse is not None else None,
        )
        return reason, (values[n_guard:] if sums is not None else None)

    def _indirect_probe(self, suspect: int, step: int) -> None:
        """Ask ``indirect_probes`` drawn healthy peers to header-probe
        ``suspect`` for us (the RELAY verb) and feed the scoreboard at most
        one summarized outcome for it: a success when any relay vouched.
        Each relay's own reachability feeds its record too.  The relays are
        :func:`~dpwa_tpu_torch.parallel.schedules.relay_draw`'s, keyed on
        (seed, step, me, slot); with the partial view on they are drawn from
        the active view."""
        sb = self.scoreboard
        view = self._view_candidates()
        candidates = [
            p for p in (view if view is not None else range(len(self.config.nodes)))
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
            if self._link_blocked(relay):
                relay_outcome, probe_outcome = Outcome.REFUSED, None
            else:
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
        replica.  Under flowctl a ``degraded`` partner (load, not death)
        keeps a share of its rounds and the rest, where
        :func:`degrade_shed_draw` falls below
        ``flowctl.degrade_shed_fraction``, go to the fallback.  Without
        health, the scheduled partner."""
        sched = self.schedule.partner(step, self.me)
        partner, remapped = sched, False
        sb = self.scoreboard
        if sb is not None and sched != self.me:
            if sb.probe_due(sched, step):
                with self._stats_lock:
                    self.stats["probes"] += 1
                if self._link_blocked(sched):
                    outcome, remote_clock = Outcome.REFUSED, None
                else:
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
            fc = self.config.flowctl
            if sb.is_quarantined(sched, step) or (
                fc.enabled
                and fc.degrade_shed_fraction > 0.0
                and sb.is_degraded(sched, step)
                and degrade_shed_draw(self.schedule.seed, step, self.me) < fc.degrade_shed_fraction
            ):
                partner = self._remap(step, sched)
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
        if self._link_blocked(peer_index):
            return None, Outcome.REFUSED, 0.0, 0
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
        if self.membership is None:
            return []
        if self.incidents is not None or self.flight is not None:
            out, self._membership_event_buf = self._membership_event_buf, []
            out.extend(self.membership.pop_events())
            return out
        return self.membership.pop_events()

    def pop_heal_advice(self) -> Optional[dict]:
        """Consume the pending heal-reconciliation advice, if any."""
        return None if self.membership is None else self.membership.pop_heal_advice()

    def pop_trust_events(self) -> list:
        """Drain the trust events (collapse, recovery, amnesty, clock
        resets)."""
        if self.trust is None:
            return []
        if self.incidents is not None or self.flight is not None:
            out, self._trust_event_buf = self._trust_event_buf, []
            out.extend(self.trust.pop_events())
            return out
        return self.trust.pop_events()

    def set_trust_leaves(self, sizes) -> None:
        """Adopt the model's leaf sizes, in the frame's order, so the
        screen's per-leaf statistic follows the real parameter boundaries
        (adapters call this once)."""
        if self.trust is not None:
            self.trust.set_leaf_sizes(sizes)

    def health_snapshot(self) -> dict:
        """JSON-ready per-peer health (what ``/healthz`` serves): the
        scoreboard's snapshot (with the membership view when that plane
        runs), plus each peer's trust columns and a top-level ``trust`` view
        when the trust plane runs, and each peer's deadline, hedge, busy and
        slow columns and a top-level ``flowctl`` view (the estimator's, with
        the server's admission counters) when flowctl runs; the ``reactor``
        scheduler's counters exactly when the reactor serves; the ``wire``
        accounting when a codec, the pipeline or the partial view is on; the
        ``obs`` document with the tracer or the sketch on and ``incidents``
        with the incident plane on."""
        if self.scoreboard is None:
            snap = {"me": self.me, "round": 0, "peers": {}}
        else:
            snap = self.scoreboard.snapshot()
        if self.trust is not None:
            tsnap = self.trust.snapshot()
            for p, info in tsnap["peers"].items():
                snap["peers"].setdefault(p, {}).update(info)
            snap["trust"] = tsnap
        if self._estimator is not None:
            fsnap = self._estimator.snapshot()
            admission = getattr(self.server, "admission", None)
            if admission is not None:
                fsnap["admission"] = admission.snapshot()
            for p, info in fsnap["peers"].items():
                snap["peers"].setdefault(p, {}).update(
                    {k: info[k] for k in ("deadline_ms", "hedges", "hedge_wins", "busy", "slow")}
                )
            snap["flowctl"] = fsnap
        reactor_snap = getattr(self.server, "reactor_snapshot", None)
        if reactor_snap is not None:
            snap["reactor"] = reactor_snap()
        if (self._wire_topk or self._shard_on or self._prefetch_on
                or (self.membership is not None and self.membership.partial is not None)):
            snap["wire"] = self.wire_snapshot()
        if self.tracer is not None or self.sketchboard is not None:
            snap["obs"] = self.obs_snapshot()
        if self.incidents is not None:
            snap["incidents"] = self.incidents.snapshot()
        if self.async_engine is not None:
            snap["async"] = self.async_engine.snapshot()
        return snap

    def obs_snapshot(self) -> dict:
        """The JSON-ready observability document: the sketch's convergence
        estimate and the tracer's per-stage summary."""
        out: dict = {}
        if self.sketchboard is not None:
            out["convergence"] = self.sketchboard.snapshot()
        if self.tracer is not None:
            out["trace"] = self.tracer.stage_summary()
        return out

    def _flight_dump_route(self) -> dict:
        """The ``/flightdump`` route: dump the ring now."""
        path = self.flight.dump("endpoint") if self.flight is not None else None
        out: dict = {"dumped": path is not None}
        if path is not None:
            out["path"] = path
        return out

    def _register_metrics(self, registry) -> None:
        """Every running plane's collectors on the ``/metrics`` registry
        (once, at the end of construction), the wire, overlap, sketch and
        tracer gauges with them; each reads its plane's snapshot at scrape
        time, nothing a round."""
        from dpwa_tpu_torch.obs.prometheus import Family

        registry.gauge_fn("dpwa_me", "This node's ring index.", lambda: self.me)
        if self.scoreboard is not None:
            from dpwa_tpu_torch.health.scoreboard import register_metrics as _reg_health

            _reg_health(registry, self.scoreboard)
        if self.membership is not None:
            from dpwa_tpu_torch.membership.manager import register_metrics as _reg_member

            _reg_member(registry, self.membership)
        if self.trust is not None:
            from dpwa_tpu_torch.trust.manager import register_metrics as _reg_trust

            _reg_trust(registry, self.trust)
        if self._estimator is not None:
            from dpwa_tpu_torch.flowctl.estimator import register_metrics as _reg_est

            _reg_est(registry, self._estimator)
        admission = getattr(self.server, "admission", None)
        if admission is not None:
            from dpwa_tpu_torch.flowctl.admission import register_metrics as _reg_adm

            _reg_adm(registry, admission)
        if hasattr(self.server, "reactor_snapshot"):
            from dpwa_tpu_torch.parallel.reactor import register_metrics as _reg_reactor

            _reg_reactor(registry, self.server)

        def _wire():
            snap = self.wire_snapshot()
            fams = [
                Family("dpwa_wire_bytes_total", "counter",
                       "Payload bytes published to the wire.").sample(snap["wire_bytes"]),
                Family("dpwa_wire_frames_total", "counter",
                       "Frames published to the wire.").sample(snap["frames"]),
                Family("dpwa_wire_compression_ratio", "gauge",
                       "Dense f32 bytes over on-wire bytes.").sample(snap["compression_ratio"]),
            ]
            ov = snap.get("overlap")
            if ov is not None:
                fams.append(Family("dpwa_overlap_occupancy", "gauge",
                                   "Fetch in-flight time over round wall time.").sample(
                    ov["occupancy"]))
                fams.append(Family("dpwa_overlap_hidden_frac", "gauge",
                                   "Fraction of fetch wall-time hidden from the caller.").sample(
                    ov["hidden_frac"]))
            return fams

        registry.register(_wire)
        if self.sketchboard is not None:

            def _sketch():
                snap = self.sketchboard.snapshot()
                return [
                    Family("dpwa_disagreement_rms", "gauge",
                           "Sketch-estimated RMS replica disagreement across peers seen.").sample(
                        snap["rms"]),
                    Family("dpwa_disagreement_rel", "gauge",
                           "RMS disagreement relative to the local replica norm estimate."
                           ).sample(snap["rel_rms"]),
                    Family("dpwa_sketch_peers", "gauge",
                           "Peers with a current sketch on the board.").sample(
                        snap["peers_seen"]),
                ]

            registry.register(_sketch)
        if self.tracer is not None:

            def _trace():
                summary = self.tracer.stage_summary()
                total = Family("dpwa_trace_stage_seconds_total", "counter",
                               "Cumulative seconds spent per exchange stage.")
                med = Family("dpwa_trace_stage_median_ms", "gauge",
                             "Median stage duration over the recent window.")
                for stage, info in summary.items():
                    total.sample(info["total_s"], {"stage": stage})
                    med.sample(info["median_ms"], {"stage": stage})
                return [total, med]

            registry.register(_trace)
        if self.incidents is not None:
            from dpwa_tpu_torch.obs.incidents import register_metrics as _reg_inc

            _reg_inc(registry, self.incidents)

    def wire_snapshot(self) -> dict:
        """JSON-ready wire accounting, as the reference's: the codec
        publishing (``shard+`` before it when sharded), the frames, their
        bytes on the wire and as dense float32, their ratio, and the host
        copies a received frame cost before its landing; the top-k settings
        and the per-shard frames, bytes and coverage (distinct shards served
        over k) when those are on; the prefetch pipeline's ``overlap``
        (rounds, rounds consumed from a slot, slots still streaming at the
        consuming publish, the fetches' and the joins' seconds, the share of
        the rounds' wall time a fetch was in flight, and the share of the
        fetch time hidden) when it runs; the partial view's ``view`` group
        (view sizes, residency, evictions by cause, promotions, shuffles,
        and the digest bytes of the last published frame) when it is on.
        The reference's receive-ring occupancy and device-engine columns are
        its own and not reported."""
        with self._stats_lock:
            t = dict(self._wire_tally)
            shard_tally = {i: dict(st) for i, st in self._shard_tally.items()}
        proto = self.config.protocol
        codec = "topk" if self._wire_topk else proto.wire_dtype
        if self._shard_on:
            codec = f"shard+{codec}"
        out = {
            "codec": codec,
            "frames": t["frames"],
            "wire_bytes": t["wire_bytes"],
            "dense_bytes": t["dense_bytes"],
            "compression_ratio": (
                round(t["dense_bytes"] / t["wire_bytes"], 4) if t["wire_bytes"] else 0.0
            ),
            "copies_per_frame": round(ingest.rx_stats()["copies_per_frame"], 4),
        }
        if self._wire_topk:
            out["topk_fraction"] = proto.topk_fraction
            out["topk_values"] = proto.topk_values
        if self._shard_on:
            k = self._shard_k
            out["shard"] = {
                "k": k,
                "frames_per_shard": [shard_tally.get(i, {}).get("frames", 0) for i in range(k)],
                "wire_bytes_per_shard": [
                    shard_tally.get(i, {}).get("wire_bytes", 0) for i in range(k)],
                "coverage": round(len(shard_tally) / k, 4),
            }
        if self.membership is not None and self.membership.partial is not None:
            view = dict(self.membership.view_snapshot().get("view") or {})
            view["view_digest_bytes"] = self.last_digest_nbytes
            out["view"] = view
        if self._prefetch_on:
            with self._stats_lock:
                o = dict(self._overlap)
            out["overlap"] = {
                "rounds": o["rounds"],
                "prefetched": o["prefetched"],
                "straddled": o["straddled"],
                "fetch_s": round(o["fetch_s"], 6),
                "join_wait_s": round(o["join_wait_s"], 6),
                "occupancy": round(o["inflight_s"] / o["round_s"], 4) if o["round_s"] > 0 else 0.0,
                "hidden_frac": (round(max(1.0 - o["join_wait_s"] / o["fetch_s"], 0.0), 4)
                                if o["fetch_s"] > 0 else 0.0),
            }
        return out

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

    def _membership_end_round(self, step: int) -> None:
        # Component and quorum state advance on skipped rounds too: a
        # partitioned node skips every round, which is when it must notice.
        if self.membership is not None:
            self.membership.end_round(step)
        if self.incidents is not None or self.flight is not None:
            self._obs_round_end(step)

    def _obs_round_end(self, step: int) -> None:
        """The incident plane's and the flight recorder's round boundary,
        on every exit of every exchange, right after the membership
        boundary: this round's evidence from what the round already made
        (``last_round``, ``last_fetch``, the scoreboard, the membership
        view, the sketch board); no wire traffic and no device sync."""
        now = time.monotonic()
        wall = None
        if self._obs_round_entry_t is not None:
            # Entry to entry: compute and exchange, the SLO burn's baseline.
            wall = now - self._obs_round_entry_t
        self._obs_round_entry_t = now
        lr = self.last_round
        this_round = lr.get("step") == step
        peer = lr.get("partner") if this_round else None
        outcome = lr.get("outcome") if this_round else None
        lf = self.last_fetch if this_round else {}
        events: list = []
        if self.membership is not None:
            evs = self.membership.pop_events()
            events.extend(evs)
            self._membership_event_buf.extend(evs)
        if self.trust is not None:
            evs = self.trust.pop_events()
            events.extend(evs)
            self._trust_event_buf.extend(evs)
        board = self.scoreboard.snapshot() if self.scoreboard is not None else None
        partition_state = component = None
        if self.membership is not None:
            view = self.membership.view_snapshot()
            partition_state = view.get("partition_state")
            component = view.get("component")
        rel = None
        if self.sketchboard is not None:
            _, rel = self.sketchboard.disagreement()
        # The peers whose frames the async loop dropped as stale this round.
        stale_peers = (self.async_engine.pop_round_stale()
                       if self.async_engine is not None else ())
        fired: list = []
        opened = False
        if self.incidents is not None:
            res = self.incidents.observe_round(
                step, outcome=outcome, peer=peer, board=board, events=events, rel_rms=rel,
                wall_s=wall, partition_state=partition_state, component=component,
                stale_peers=stale_peers,
            )
            fired = res["alerts"]
            opened = res["opened"]
        if self.flight is not None:
            self.flight.note_round(
                step,
                partner=peer,
                sched_partner=lr.get("sched_partner") if this_round else None,
                remapped=lr.get("remapped") if this_round else None,
                outcome=outcome,
                codec=lr.get("codec") if this_round else None,
                trust=lr.get("trust") if this_round else None,
                latency_s=lf.get("latency_s"),
                nbytes=lf.get("nbytes"),
                rel_rms=rel,
                wall_s=round(wall, 6) if wall is not None else None,
                partition_state=partition_state,
                events=[e.get("event") for e in events] or None,
                alerts=fired or None,
            )
            if opened:
                # An incident's open dumps the run-up before the ring moves on.
                self.flight.dump("incident", step)

    def _trace_finish(self, tr) -> None:
        """Close the traced round with its resolution (``last_round``,
        ``last_fetch``) and the sketch's disagreement estimate.  A merge on
        the card is timed by CUDA events around its launch; they are read
        here, so a traced round waits for its merge's end event (the one
        sync the tracer adds: the next round's publish reads the merged
        replica back, and would wait for it anyway)."""
        events, self._merge_events = self._merge_events, None
        if events is not None:
            start, end = events
            end.synchronize()
            tr.mark("merge", start.elapsed_time(end) / 1e3)
        lr = self.last_round
        fields = {
            "partner": lr.get("partner"),
            "sched_partner": lr.get("sched_partner"),
            "remapped": lr.get("remapped"),
            "outcome": lr.get("outcome"),
            "codec": lr.get("codec"),
        }
        if lr.get("outcome") is not None:
            fields["nbytes"] = self.last_fetch.get("nbytes")
        if lr.get("hedged"):
            fields["hedged"] = True
        if self.sketchboard is not None:
            rms, rel = self.sketchboard.disagreement()
            fields["disagreement_rms"] = rms
            fields["disagreement_rel"] = rel
        tr.end_round(**fields)

    def _traced_merge(self, tr, x: torch.Tensor, remote, alpha: float) -> torch.Tensor:
        """:func:`engine.merge` on a traced round: between two CUDA events
        on the card (read by :meth:`_trace_finish`), timed by the host
        clock elsewhere."""
        if x.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            merged = engine.merge(x, remote, alpha)
            end.record()
            self._merge_events = (start, end)
        else:
            t0 = time.monotonic()
            merged = engine.merge(x, remote, alpha)
            tr.mark("merge", time.monotonic() - t0)
        tr.set(alpha=float(alpha))
        return merged

    def _start_round(self, step: int, sched: int, partner: int, remapped: bool) -> None:
        self.last_round = {
            "step": step, "sched_partner": sched, "partner": partner,
            "remapped": remapped, "outcome": None,
        }

    def _weighed(self, got: Optional[tuple], clock: float, loss: float, partner: int):
        """The round's fetch outcome into :attr:`last_round`, and ``(what
        merges or None, α, partner)``."""
        self.last_round["outcome"] = self.last_fetch.get("outcome")
        if "trust" in self.last_fetch:
            self.last_round["trust"] = self.last_fetch["trust"]
        if "codec" in self.last_fetch:
            self.last_round["codec"] = self.last_fetch["codec"]
        if self.last_fetch.get("hedged"):
            self.last_round["hedged"] = True
            self.last_round["hedge_winner"] = self.last_fetch.get("hedge_winner")
        if got is None:
            return None, 0.0, partner
        self._round_clock = got[1]
        return got[0].merge, self._weigh(got, clock, loss), partner

    def _round(self, rep: DeviceReplica, clock: float, loss: float, step: int):
        """Publish, resolve the partner, check participation, fetch, guard,
        screen, weigh: ``(remote or None, α, partner)``; None skips the
        merge.  The membership round boundary runs on every exit."""
        try:
            self._publish_replica(rep, clock, loss)
            tr = self.tracer
            timing = tr is not None and tr.active
            t0 = time.monotonic() if timing else 0.0
            sched, partner, remapped = self._resolve_partner(step)
            if timing:
                tr.mark("partner_resolve", time.monotonic() - t0)
            self._start_round(step, sched, partner, remapped)
            # Participation stays keyed on the scheduled pairing; a remap
            # moves only the fetch (to self when no healthy peer is left).
            if partner == self.me or not self.schedule.participates(step, self.me):
                return None, 0.0, partner
            got = self.fetch(partner, step=step, device=rep.dev.device, landed=True)
            return self._weighed(got, clock, loss, partner)
        finally:
            self._membership_end_round(step)

    # -- the prefetch pipeline ------------------------------------------
    def _round_pipelined(self, rep: DeviceReplica, clock: float, loss: float, step: int):
        """:meth:`_round` through the double-buffered prefetch slot: publish,
        take the slot that has streamed this round's frame since the last
        round (the caller's compute hid it), launch round ``step + 1``'s
        slot, then land, guard, screen and weigh this round's frame against
        the replica just published.  Failures are charged to the consuming
        round's step; a chaos partition that opened after the launch still
        refuses the frame (:meth:`_prefetch_take`)."""
        t_entry = time.monotonic()
        with self._stats_lock:
            o = self._overlap
            if self._pipe_last_entry is not None:
                # Entry to entry: compute and exchange, the occupancy's denominator.
                o["round_s"] += t_entry - self._pipe_last_entry
            self._pipe_last_entry = t_entry
            o["rounds"] += 1
        try:
            self._publish_replica(rep, clock, loss)
            raw, sched, partner, remapped = self._prefetch_take(step)
            self._start_round(step, sched, partner, remapped)
            # Round t+1's wire leg streams while this round is consumed.
            self._prefetch_launch(step + 1, self._wire_nbytes(rep.dev.numel()))
            if raw is None:
                return None, 0.0, partner
            got = self._consume_fetch(raw, step, rep.dev.device)
            del raw
            return self._weighed(got, clock, loss, partner)
        finally:
            self._membership_end_round(step)

    def _prefetch_launch(self, step: int, expected_nbytes: int) -> None:
        """Arm the slot for round ``step``: its partner resolved now, one
        scoreboard round early, and its frame streamed on a background
        thread (none when that round does not fetch)."""
        tr = self.tracer
        timing = tr is not None and tr.active
        t0 = time.monotonic() if timing else 0.0
        sched, partner, remapped = self._resolve_partner(step)
        if timing:
            tr.mark("partner_resolve", time.monotonic() - t0)
        slot = None
        if partner != self.me and self.schedule.participates(step, self.me):
            slot = _Slot(self, partner, step)
        old, self._prefetch_slot = self._prefetch_slot, {
            "step": step, "sched": sched, "partner": partner, "remapped": remapped,
            "expected_nbytes": int(expected_nbytes), "slot": slot,
        }
        if old is not None and old["slot"] is not None:
            old["slot"].abandon()

    def _prefetch_take(self, step: int) -> tuple:
        """Claim round ``step``'s slot: ``(raw or None, sched, partner,
        remapped)``.  A cold pipeline or a step that does not follow the
        last resolves and fetches here, synchronously (all of it join
        wait).  The join waits as long as the fetch's own deadline can run
        (:meth:`_join_backstop_s`); a lapsed join skips the merge."""
        entry, self._prefetch_slot = self._prefetch_slot, None
        tr = self.tracer
        timing = tr is not None and tr.active
        if entry is None or entry["step"] != step:
            if entry is not None and entry["slot"] is not None:
                entry["slot"].abandon()
            sched, partner, remapped = self._resolve_partner(step)
            if partner == self.me or not self.schedule.participates(step, self.me):
                return None, sched, partner, remapped
            t0 = time.monotonic()
            raw = self._wire_fetch(partner, None, step)
            dt = time.monotonic() - t0
            with self._stats_lock:
                o = self._overlap
                o["fetch_s"] += dt
                o["join_wait_s"] += dt
                o["inflight_s"] += dt
            if timing:
                tr.mark("join_wait", dt)
                tr.set(prefetched=False)
            return raw, sched, partner, remapped
        sched, partner, remapped = entry["sched"], entry["partner"], entry["remapped"]
        slot = entry["slot"]
        if slot is None:
            return None, sched, partner, remapped
        # Still streaming as this round's publish landed: the frame straddled
        # a publish, and the consume-time screen is what judges it.
        straddled = slot.t_end == 0.0
        with self._stats_lock:
            self._overlap["prefetched"] += 1
            self._overlap["straddled"] += straddled
        if timing:
            tr.set(prefetched=True, straddled=straddled)
        t_join = time.monotonic()
        raw = slot.take(self._join_backstop_s(entry["expected_nbytes"]))
        join_dt = time.monotonic() - t_join
        if timing:
            tr.mark("join_wait", join_dt)
        span = max((slot.t_end or time.monotonic()) - slot.t_start, 0.0)
        with self._stats_lock:
            o = self._overlap
            o["join_wait_s"] += join_dt
            o["fetch_s"] += span
            o["inflight_s"] += span
        if raw is None:
            return None, sched, partner, remapped
        if self._link_blocked(partner):
            # A partition keyed on the consuming round's publish clock refuses
            # the frame the launch (one clock earlier) let through.
            _recycle_raw(raw)
            raw = (partner, None, Outcome.REFUSED, 0.0, 0, [], None, False, None, None)
        return raw, sched, partner, remapped

    def _join_backstop_s(self, expected_nbytes: int) -> float:
        """How long a join waits for a background fetch: 1 s of slack, the
        fetch's deadline (doubled under flowctl, whose hedge may run a
        second leg, from the larger of ``timeout_ms`` and ``flowctl.max_ms``)
        and the per-byte allowance for ``expected_nbytes`` on the wire."""
        proto, fc = self.config.protocol, self.config.flowctl
        base_s = proto.timeout_ms / 1000.0
        if fc.enabled:
            base_s = 2.0 * max(base_s, fc.max_ms / 1000.0)
        return 1.0 + base_s + expected_nbytes / (proto.min_wire_mb_per_s * 1e6)

    def _wire_nbytes(self, n: int) -> int:
        """The payload bytes this node's frame of a replica of ``n`` floats
        takes on the wire, as published: a partner's frame is as large, so
        it sizes a join's backstop (int8, top-k and shard aware; a shard
        frame sized by the longest slice)."""
        proto = self.config.protocol

        def body(m: int) -> int:
            if self._wire_topk:
                return topk_nbytes(m, topk_k(m, proto.topk_fraction), proto.topk_values)
            if self.wire == "int8":
                return int8_nbytes(m)
            return 2 * m if self.wire == "bf16" else 4 * m

        if self._shard_on:
            return pc.SHARD_HDR.size + body(-(-n // self._shard_k))
        return body(n)

    # -- the exchanges --------------------------------------------------
    def _count_round(self, merged: Sequence[Tuple[int, float]]) -> None:
        """Tally a round and the ``(peer, publish clock)`` of each frame it
        merged (a hedge's winner may be the fallback)."""
        with self._stats_lock:
            self.stats["rounds"] += 1
            self.stats["merged"] += bool(merged)
            for peer, clock in merged:
                seen = self.stats["merged_from"].setdefault(peer, [0, clock])
                seen[0] += 1
                seen[1] = max(seen[1], clock)

    def exchange_on_device(self, vec_dev: torch.Tensor, clock: float, loss: float, step: int):
        """One gossip round for a flat float32 replica on the card (or any
        device): ``(merged, α, partner)``, the merged replica a new tensor
        on the same device, or ``vec_dev`` itself when the round was
        skipped (α = 0).  With ``overlap_prefetch`` the round goes through
        the prefetch pipeline (:meth:`_round_pipelined`).  With ``obs.trace``
        the round is traced (one round in ``trace_every``).  With
        ``async_rounds`` it is the async engine's barrier-free round, and α
        is the damped α of this round's partner when its frame merged, else
        of the last frame merged (0.0 when none did)."""
        if self.async_engine is not None:
            merged, merges = self.async_engine.exchange_on_device(vec_dev, clock, loss, step)
            partner = self.last_round.get("partner", self.me)
            alpha = merges[-1][1] if merges else 0.0
            for peer, damped, _lag in merges:
                if peer == partner:
                    alpha = damped
            return merged, alpha, partner
        rep = self._replica(_flat(vec_dev))
        round_fn = self._round_pipelined if self._prefetch_on else self._round
        tr = self.tracer
        rt = tr is not None and tr.begin_round(step)
        try:
            remote, alpha, partner = round_fn(rep, clock, loss, step)
            self._count_round(
                () if remote is None else ((self.last_fetch["peer"], self._round_clock),))
            if remote is None:
                return rep.dev, alpha, partner
            merged = (self._traced_merge(tr, rep.dev, remote, alpha) if rt
                      else engine.merge(rep.dev, remote, alpha))
            rep.swap(merged)
            return merged, alpha, partner
        finally:
            if rt:
                self._trace_finish(tr)

    def exchange_overlapped_start(self, vec, clock: float, loss: float, step: int
                                  ) -> _OverlappedExchange:
        """Begin a round that overlaps the partner's fetch with the
        caller's compute: publish ``vec`` (the pre-step replica), resolve
        the partner and start the fetch on a background thread; the caller
        runs its local step, then calls :meth:`_OverlappedExchange.finish`
        with the pre-step vector and the step's update."""
        self.publish(vec, clock, loss)
        n = vec.size if isinstance(vec, np.ndarray) else vec.numel()
        ex = _OverlappedExchange(self, clock, loss, step, expected_nbytes=self._wire_nbytes(n))
        ex.start()
        return ex

    def exchange_on_device_fold(self, vec_dev: torch.Tensor, clock: float, loss: float,
                                step: int, peers: Sequence[int]):
        """The fan-in round: publish, fetch a frame from each of ``peers``
        (this node skipped), each landed, guarded, screened and recorded as
        a pairwise round's, then merge the accepted ones in arrival order:
        runs of two or more dense frames (float32, an int8 frame
        dequantised) by one launch of B2's fold form, a bf16, top-k or shard
        frame by its own form of B2; bit-equal to the merges one after the
        other.  Returns ``(merged, merges)``, ``merges`` the ``(peer, α)``
        applied, in order."""
        rep = self._replica(_flat(vec_dev))
        self._publish_replica(rep, clock, loss)
        frames, clocks = [], []
        try:
            for peer in peers:
                if peer == self.me:
                    continue
                got = self._fetch_landed(peer, None, step, rep.dev.device)
                if got is None:
                    continue
                frames.append(self._classify_device_frame(got[0], peer,
                                                          self._weigh(got, clock, loss)))
                clocks.append((self.last_fetch["peer"], got[1]))
        finally:
            self._membership_end_round(step)
        merged = self._apply_device_frames(rep.dev, frames)
        self._count_round(clocks)
        if merged is not rep.dev:
            rep.swap(merged)
        return merged, [(peer, alpha) for _kind, _landed, peer, alpha in frames]

    @staticmethod
    def _classify_device_frame(landed: "_Landed", peer: int, alpha: float) -> tuple:
        """``(kind, landed, peer, α)``: ``dense`` for a float32 frame or an
        int8 one (decoded to float32, as the reference decodes it), else
        ``bf16``, ``topk`` or ``shard``."""
        m = landed.merge
        if isinstance(m, TopkPayload):
            kind = "topk"
        elif isinstance(m, ShardPayload):
            kind = "shard"
        elif isinstance(m, torch.Tensor) and m.dtype == torch.bfloat16:
            kind = "bf16"
        else:
            kind = "dense"
        return kind, landed, peer, alpha

    @staticmethod
    def _apply_device_frames(start: torch.Tensor, frames: Sequence[tuple],
                             fold: bool = True) -> torch.Tensor:
        """Merge ``frames`` (:meth:`_classify_device_frame`'s) onto
        ``start`` in order: runs of two or more dense frames by one fold
        launch (with ``fold``), any other frame by its own form of B2 (a
        lone int8 frame by B2's int8-frame form, which is bit-equal).
        Returns the merged replica (``start`` itself for no frames)."""
        merged = start
        run: List[tuple] = []

        def flush() -> None:
            nonlocal merged
            if len(run) >= 2 and fold:
                merged = engine.fold(merged, [landed.vector() for landed, _a in run],
                                     [a for _landed, a in run])
            else:
                for landed, a in run:
                    merged = engine.merge(merged, landed.merge, a)
            run.clear()

        for kind, landed, _peer, alpha in frames:
            if kind == "dense":
                run.append((landed, alpha))
                continue
            flush()
            merged = engine.merge(merged, landed.merge, alpha)
        flush()
        return merged

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
        """Stop serving; a prefetch slot is abandoned and the async engine's
        in-flight fetches are joined, every frame they hold given back to
        the receive ring; the flight recorder dumps, and the tracer's and
        the incident plane's files are closed."""
        entry, self._prefetch_slot = self._prefetch_slot, None
        if entry is not None and entry["slot"] is not None:
            entry["slot"].abandon()
        if self.async_engine is not None:
            self.async_engine.release()
        if self.flight is not None:
            # The close's dump, then no crash hooks: a later atexit dump
            # must not replace it.
            self.flight.dump("close")
            self.flight.disarm()
        if self.incidents is not None:
            self.incidents.close()
        if self.healthz is not None:
            self.healthz.close()
        # The server first: its last serve spans reach the tracer before the
        # tracer's file closes.
        self.server.close()
        if self.tracer is not None:
            self.tracer.close()
