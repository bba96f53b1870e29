"""The reactor Rx server: one event-loop thread serves every peer (the port
of :mod:`dpwa_tpu.parallel.reactor`).

:class:`ReactorPeerServer` is the ``selectors`` replacement for the
thread-per-connection :class:`~dpwa_tpu_torch.parallel.tcp.PeerServer`,
selected by ``protocol.rx_server: reactor``.  An admitted connection costs
a registered socket and a small state machine instead of a thread, so one
process serves large rings without spawning anything.

The bytes are the threaded server's: every response is built by
:mod:`dpwa_tpu_torch.parallel.tcp`'s frame builders and the constants of
:mod:`~dpwa_tpu_torch.parallel.protocol_constants`, never here, so a
fetcher of either package cannot tell the servers apart.

Each connection is one request in, one framed response out, then a close::

    REQ ── DPWA? ──────────────────────────▶ WRITE (frame | DPWB busy)
     │──── DPWA@ ──▶ STATE_BODY ───────────▶ WRITE (one DPWS chunk)
     │──── DPWA! ──▶ RELAY_BODY ─▶ RELAY_HOST ─▶ RELAY_WAIT ─▶ WRITE
     └──── anything else ──────────────────▶ close

Flow control is the threaded server's, knob for knob: admission (the token
bucket, and the connection cap lifted to ``flowctl.reactor_max_connections``,
since a connection is no longer a thread) at accept, the in-flight-bytes
ceiling at serve, the ``DPWB`` busy frame on refusal, and slow-loris
eviction: a hashed timer wheel holds every connection's deadline (``base +
ingested bytes · per_byte`` while the request is read, refreshed by
progress while the response is written) and the loop closes the expired
ones.

Threads: the loop, and one helper for relay probes (``DPWA!`` asks for a
blocking header probe of a third node, up to ``MAX_RELAY_TIMEOUT_MS``);
its completions come back through a queue and a self-pipe wake-up.  Reads
land in one preallocated scratch buffer, requests are parsed in place, and
frames and state chunks go out as segment lists through non-blocking
``sendmsg``, header and payload never joined.  :func:`register_metrics`
exposes the scheduler on ``/metrics`` as ``dpwa_reactor_*``.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import selectors
import socket
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import torch

from dpwa_tpu_torch.config import FlowctlConfig
from dpwa_tpu_torch.flowctl import AdmissionController
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.parallel import ingest
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel import tcp as _tcp

# Connection phases.
_PH_REQ = "req"
_PH_STATE_BODY = "state_body"
_PH_RELAY_BODY = "relay_body"
_PH_RELAY_HOST = "relay_host"
_PH_RELAY_WAIT = "relay_wait"
_PH_WRITE = "write"
# Phases whose deadline counts as a slow-loris eviction (the threaded
# server counts one only for the request and STATE-body read).
_INGEST_PHASES = (_PH_REQ, _PH_STATE_BODY)

_ACCEPT_BATCH = 64  # accepts drained per readiness event
_RECV_CHUNK = 65536
_SHED_TIMEOUT_S = 0.5  # the budget of a busy reply
_RELAY_SLACK_S = 5.0  # queue slack on top of the clamped probe budget


class _Conn:
    """One accepted connection's state (loop thread only)."""

    __slots__ = (
        "sock", "host", "admitted", "phase", "inbuf", "need", "outbuf", "outsegs", "sent",
        "base_deadline", "deadline", "per_byte", "ingested", "write_timeout", "reserved",
        "is_blob", "trace_id", "t0", "relay", "seq", "slot", "closed",
    )

    def __init__(self, sock: socket.socket, host: str, admitted: bool):
        self.sock = sock
        self.host = host
        self.admitted = admitted
        self.phase = _PH_REQ
        self.inbuf = bytearray()
        self.need = len(pc.BLOB_REQ)
        # One response form at a time: ``outbuf`` for one buffer (busy,
        # relay, a chaos frame), ``outsegs`` for a segment list the writer
        # advances in place.
        self.outbuf: Optional[memoryview] = None
        self.outsegs: Optional[List[memoryview]] = None
        self.sent = 0
        self.base_deadline = 0.0
        self.deadline = 0.0
        self.per_byte = 0.0
        self.ingested = 0
        self.write_timeout = 0.0
        self.reserved = 0  # bytes held against the in-flight ceiling
        self.is_blob = False
        self.trace_id: Optional[str] = None  # the served frame's, for its span
        self.t0 = 0.0
        self.relay: Optional[Tuple[int, int, int]] = None
        self.seq = 0
        self.slot = -1  # timer-wheel slot, -1 when not filed
        self.closed = False


class _TimerWheel:
    """A hashed timer wheel, re-filed lazily: connections are filed by
    ``deadline // granularity`` modulo the slot count, and a firing slot
    re-checks each member's current deadline, re-filing the ones not due
    (a deadline that progress moved never touches the wheel on the hot
    path)."""

    def __init__(self, granularity: float = 0.05, nslots: int = 128):
        self.granularity = granularity
        self.nslots = nslots
        self.slots: List[set] = [set() for _ in range(nslots)]
        self.tick = 0  # the next absolute tick to process

    def start(self, now: float) -> None:
        self.tick = int(now / self.granularity)

    def file(self, conn: _Conn, min_tick: Optional[int] = None) -> None:
        idx = max(int(conn.deadline / self.granularity),
                  self.tick if min_tick is None else min_tick)
        slot = idx % self.nslots
        if conn.slot == slot:
            return
        self.unfile(conn)
        conn.slot = slot
        self.slots[slot].add(conn)

    def unfile(self, conn: _Conn) -> None:
        if conn.slot >= 0:
            self.slots[conn.slot].discard(conn)
            conn.slot = -1

    def expired(self, now: float) -> List[_Conn]:
        out: List[_Conn] = []
        target = int(now / self.granularity)
        while self.tick <= target:
            slot = self.slots[self.tick % self.nslots]
            for conn in list(slot):
                slot.discard(conn)
                conn.slot = -1
                if conn.deadline <= now:
                    out.append(conn)
                else:
                    # Not due (refreshed, or a wrapped far deadline): re-file
                    # strictly after this tick, whose members were taken.
                    self.file(conn, min_tick=self.tick + 1)
            self.tick += 1
        return out


class ReactorPeerServer:
    """The event-loop Rx server.  Its surface is :class:`~dpwa_tpu_torch.
    parallel.tcp.PeerServer`'s (``publish``, ``publish_state``, ``close``,
    ``port``, ``admission``, ``relay_guard``) and :meth:`reactor_snapshot`."""

    relay_guard = None
    obs_serve_hook = None

    def __init__(self, host: str, port: int, flowctl: Optional[FlowctlConfig] = None):
        self._lock = threading.Lock()
        self._segments: Optional[tuple] = None
        self._payload_nbytes = 0
        self._payload_trace_id: Optional[str] = None
        self._state = None
        self._state_gen = 0
        self.flowctl = flowctl if flowctl is not None else FlowctlConfig()
        # The threaded server's admission, its cap lifted to
        # reactor_max_connections: the cap bounds registered sockets here,
        # not worker threads.
        self.admission: Optional[AdmissionController] = (
            AdmissionController(dataclasses.replace(
                self.flowctl, max_connections=self.flowctl.reactor_max_connections))
            if self.flowctl.enabled else None
        )
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, port))
            # A deep backlog: a large ring's round start is an accept burst.
            self._sock.listen(256)
            self._sock.setblocking(False)
        except OSError:
            self._sock.close()
            raise
        self.port = self._sock.getsockname()[1]
        self._sel = selectors.DefaultSelector()
        # Self-pipe: the relay helper and close() wake the selector.
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._relay_jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._relay_done: queue.SimpleQueue = queue.SimpleQueue()
        self._relay_pending: Dict[int, _Conn] = {}  # loop thread only
        self._relay_seq = itertools.count(1)
        self._scratch = bytearray(_RECV_CHUNK)
        self._scratch_view = memoryview(self._scratch)
        self._wheel = _TimerWheel()
        self._stats_lock = threading.Lock()
        self._stats = {
            "accepted": 0, "open": 0, "peak_open": 0, "evicted": 0, "busy_shed": 0,
            "frames": 0, "relay_pending": 0, "loop_lag_ms": 0.0, "ready_depth": 0,
        }
        self._stop = threading.Event()
        self._relay_thread = threading.Thread(
            target=self._relay_worker, name=f"dpwa-torch-rx-relay:{self.port}", daemon=True)
        self._relay_thread.start()
        self._thread = threading.Thread(
            target=self._run, name=f"dpwa-torch-rx-reactor:{self.port}", daemon=True)
        self._thread.start()

    # -- the publish surface (the threaded server's) --------------------
    def publish(self, payload: torch.Tensor, clock: float, loss: float,
                digest: Optional[bytes] = None, code: Optional[int] = None,
                obs: Optional[bytes] = None, trace_id: Optional[str] = None) -> None:
        """Serve ``payload`` (a host tensor the caller no longer changes;
        with ``code``, a codec's encoded body) with ``clock`` and ``loss``,
        and ``digest`` and ``obs`` as its trailers, from now on; a served
        frame's span is stamped with ``trace_id``."""
        segments = _tcp._frame_segments(payload, clock, loss, digest, code, obs)
        nbytes = sum(len(s) for s in segments)
        with self._lock:
            self._segments = segments
            self._payload_nbytes = nbytes
            self._payload_trace_id = trace_id

    def publish_state(self, blob) -> None:
        """Serve a packed train state from now on: bytes, or a callable
        packing them at the first STATE request (as
        :meth:`PeerServer.publish_state`)."""
        state = _tcp._LazyState(blob) if callable(blob) else bytes(blob)
        with self._lock:
            self._state = state
            self._state_gen = (self._state_gen + 1) & 0xFFFFFFFF

    @property
    def _payload(self) -> Optional[bytes]:
        """The published frame as one byte string (lock-free)."""
        segs = self._segments
        return None if segs is None else b"".join(bytes(s) for s in segs)

    def reactor_snapshot(self) -> dict:
        """JSON-ready scheduler state (``health_snapshot``'s ``reactor``):
        open connections and their peak, accepted, evicted by a deadline,
        busy frames sent, frames served whole, relay probes in flight, the
        loop's lag (an average of an iteration's processing ms) and the
        last iteration's ready connections."""
        with self._stats_lock:
            s = dict(self._stats)
        s["loop_lag_ms"] = round(s["loop_lag_ms"], 3)
        return {k: s[k] for k in ("open", "peak_open", "accepted", "evicted", "busy_shed",
                                  "frames", "relay_pending", "loop_lag_ms", "ready_depth")}

    def close(self) -> None:
        self._stop.set()
        self._relay_jobs.put(None)
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass
        self._thread.join(timeout=2.0)
        self._relay_thread.join(timeout=2.0)
        for sock in (self._sock, self._wake_w, self._wake_r):
            try:
                sock.close()
            except OSError:
                pass

    # -- the loop ---------------------------------------------------------
    def _run(self) -> None:
        sel = self._sel
        try:
            sel.register(self._sock, selectors.EVENT_READ, None)
            sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        except (OSError, ValueError):
            return
        self._wheel.start(time.monotonic())
        while not self._stop.is_set():
            try:
                events = sel.select(self._wheel.granularity)
            except OSError:
                break
            t0 = time.monotonic()
            depth = 0
            for key, mask in events:
                if key.data is None:
                    self._on_accept(t0)
                elif key.data == "wake":
                    self._drain_wake()
                else:
                    depth += 1
                    self._on_event(key.data, mask)
            self._drain_relay_done()
            now = time.monotonic()
            for conn in self._wheel.expired(now):
                self._on_deadline(conn, now)
            # The lag: this iteration's processing time; it grows toward the
            # poll period and past it when the loop saturates.
            lag_ms = (time.monotonic() - t0) * 1000.0
            with self._stats_lock:
                st = self._stats
                st["loop_lag_ms"] += 0.1 * (lag_ms - st["loop_lag_ms"])
                st["ready_depth"] = depth
        self._shutdown()

    def _shutdown(self) -> None:
        for key in list(self._sel.get_map().values()):
            if isinstance(key.data, _Conn):
                self._close_conn(key.data)
        try:
            self._sel.close()
        except (OSError, RuntimeError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except OSError:  # BlockingIOError included: drained
            pass

    # -- accept and admission -------------------------------------------
    def _on_accept(self, now: float) -> None:
        for _ in range(_ACCEPT_BATCH):
            try:
                sock, addr = self._sock.accept()
            except OSError:  # BlockingIOError included: the backlog is drained
                return
            host = addr[0] if addr else ""
            try:
                sock.setblocking(False)
            except OSError:
                continue
            if self.admission is not None:
                ok, retry_ms = self.admission.admit(host)
                if not ok:
                    self._shed(sock, host, retry_ms, now)
                    continue
            conn = _Conn(sock, host, admitted=self.admission is not None)
            fc = self.flowctl
            conn.base_deadline = conn.deadline = now + fc.request_timeout_ms / 1000.0
            conn.write_timeout = fc.request_timeout_ms / 1000.0
            if fc.enabled and fc.min_ingest_bytes_per_s > 0:
                conn.per_byte = 1.0 / fc.min_ingest_bytes_per_s
            if not self._register(conn, selectors.EVENT_READ):
                continue
            with self._stats_lock:
                st = self._stats
                st["accepted"] += 1
                st["open"] += 1
                st["peak_open"] = max(st["peak_open"], st["open"])

    def _shed(self, sock: socket.socket, host: str, retry_ms: int, now: float) -> None:
        """Answer an unadmitted connection with the busy frame, a write on
        a short budget (the threaded server's blocking send, scheduled)."""
        conn = _Conn(sock, host, admitted=False)
        conn.phase = _PH_WRITE
        conn.outbuf = memoryview(_tcp._busy_frame(retry_ms))
        conn.write_timeout = _SHED_TIMEOUT_S
        conn.deadline = now + _SHED_TIMEOUT_S
        if not self._register(conn, selectors.EVENT_WRITE):
            return
        with self._stats_lock:
            st = self._stats
            st["busy_shed"] += 1
            st["open"] += 1
            st["peak_open"] = max(st["peak_open"], st["open"])
        self._on_writable(conn)  # usually one send

    def _register(self, conn: _Conn, mask: int) -> bool:
        try:
            self._sel.register(conn.sock, mask, conn)
        except (OSError, ValueError, KeyError):
            try:
                conn.sock.close()
            except OSError:
                pass
            if conn.admitted and self.admission is not None:
                self.admission.release(conn.host)
            return False
        self._wheel.file(conn)
        return True

    # -- readiness --------------------------------------------------------
    def _on_event(self, conn: _Conn, mask: int) -> None:
        if conn.closed:
            return
        if mask & selectors.EVENT_READ:
            self._on_readable(conn)
        if not conn.closed and mask & selectors.EVENT_WRITE:
            self._on_writable(conn)

    def _on_readable(self, conn: _Conn) -> None:
        try:
            got = conn.sock.recv_into(self._scratch)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not got:
            # EOF: the client gave up mid-request, or left while we probe.
            self._close_conn(conn)
            return
        if conn.phase in (_PH_WRITE, _PH_RELAY_WAIT):
            return  # bytes past the request are ignored, as the threaded server's
        conn.ingested += got
        conn.inbuf += self._scratch_view[:got]
        now = time.monotonic()
        if conn.per_byte > 0.0 and conn.phase in _INGEST_PHASES:
            # Slow-loris: the cumulative deadline grows per byte at the
            # minimum ingest rate.
            conn.deadline = conn.base_deadline + conn.ingested * conn.per_byte
        else:
            conn.deadline = now + conn.write_timeout  # an idle timeout
        self._advance(conn, now)

    def _advance(self, conn: _Conn, now: float) -> None:
        """Parse as far as the buffered bytes allow, in place (no view is
        held across a ``del``: a live export makes a bytearray resize
        raise)."""
        while not conn.closed and len(conn.inbuf) >= conn.need:
            if conn.phase == _PH_REQ:
                # The three request magics share one length.
                if conn.inbuf.startswith(pc.BLOB_REQ):
                    del conn.inbuf[:conn.need]
                    self._serve_blob(conn, now)
                    return
                if conn.inbuf.startswith(pc.STATE_REQ):
                    del conn.inbuf[:conn.need]
                    conn.phase, conn.need = _PH_STATE_BODY, pc.STATE_REQ_BODY.size
                    continue
                if conn.inbuf.startswith(pc.RELAY_REQ):
                    del conn.inbuf[:conn.need]
                    conn.phase, conn.need = _PH_RELAY_BODY, pc.RELAY_BODY.size
                    continue
                self._close_conn(conn)  # a garbage request
                return
            if conn.phase == _PH_STATE_BODY:
                offset, max_chunk = pc.STATE_REQ_BODY.unpack_from(conn.inbuf, 0)
                del conn.inbuf[:conn.need]
                self._serve_state(conn, offset, max_chunk, now)
                return
            if conn.phase == _PH_RELAY_BODY:
                target, port, timeout_ms, hostlen = pc.RELAY_BODY.unpack_from(conn.inbuf, 0)
                del conn.inbuf[:conn.need]
                conn.relay = (int(target), int(port), int(timeout_ms))
                if hostlen:
                    conn.phase, conn.need = _PH_RELAY_HOST, int(hostlen)
                    continue
                self._start_relay(conn, "127.0.0.1", now)
                return
            if conn.phase == _PH_RELAY_HOST:
                host = conn.inbuf[:conn.need].decode("ascii", "replace")
                del conn.inbuf[:conn.need]
                self._start_relay(conn, host, now)
            return

    # -- the responses ----------------------------------------------------
    def _serve_blob(self, conn: _Conn, now: float) -> None:
        """Queue the published frame's segments under the in-flight-bytes
        ceiling (past it, the busy frame); nothing published is a close."""
        with self._lock:
            segments, nbytes = self._segments, self._payload_nbytes
            trace_id = self._payload_trace_id
        if segments is None:
            self._close_conn(conn)
            return
        adm = self.admission
        if adm is not None and not adm.reserve_bytes(nbytes):
            self._queue_busy(conn, self.flowctl.busy_retry_ms, now)
            return
        conn.reserved = nbytes
        conn.is_blob = True
        conn.trace_id = trace_id
        conn.t0 = now
        self._queue_segments(conn, segments, now)

    def _queue_busy(self, conn: _Conn, retry_ms: int, now: float) -> None:
        with self._stats_lock:
            self._stats["busy_shed"] += 1
        self._queue_write(conn, _tcp._busy_frame(retry_ms), now)

    def _serve_state(self, conn: _Conn, offset: int, max_chunk: int, now: float) -> None:
        """One STATE chunk, as the threaded server's (no published state is
        the empty transfer)."""
        with self._lock:
            state, gen = self._state, self._state_gen
        blob = state.get() if isinstance(state, _tcp._LazyState) else (state or b"")
        total = len(blob)
        off = min(max(offset, 0), total)
        n = min(max(max_chunk, 0), total - off, pc.MAX_STATE_CHUNK_BYTES)
        # A view of the published bytes: a republish swaps the object.
        chunk = memoryview(blob)[off:off + n]
        header = pc.STATE_HDR.pack(pc.STATE_MAGIC, 1, gen, total, off, n, zlib.crc32(chunk))
        self._queue_segments(conn, (header, chunk), now)

    # -- relay probes (the one blocking verb, on the helper thread) ------
    def _start_relay(self, conn: _Conn, host: str, now: float) -> None:
        target, port, timeout_ms = conn.relay
        timeout_ms = min(max(timeout_ms, 1), pc.MAX_RELAY_TIMEOUT_MS)
        guard = self.relay_guard
        if guard is not None and guard(target):
            self._relay_reply(conn, Outcome.REFUSED, None, now)
            return
        # Reading stays registered: an EOF while we probe drops the answer.
        conn.phase = _PH_RELAY_WAIT
        conn.seq = next(self._relay_seq)
        self._relay_pending[conn.seq] = conn
        conn.deadline = now + timeout_ms / 1000.0 + _RELAY_SLACK_S
        self._wheel.file(conn)
        with self._stats_lock:
            self._stats["relay_pending"] += 1
        self._relay_jobs.put((conn.seq, host, port, timeout_ms))

    def _relay_worker(self) -> None:
        while True:
            job = self._relay_jobs.get()
            if job is None:
                return
            seq, host, port, timeout_ms = job
            try:
                outcome, clock = _tcp.probe_header_classified(host, port, timeout_ms)
            except Exception:
                outcome, clock = None, None  # the loop closes the connection
            self._relay_done.put((seq, outcome, clock))
            try:
                self._wake_w.send(b"\0")
            except OSError:
                return

    def _drain_relay_done(self) -> None:
        while True:
            try:
                seq, outcome, clock = self._relay_done.get_nowait()
            except queue.Empty:
                return
            with self._stats_lock:
                self._stats["relay_pending"] -= 1
            conn = self._relay_pending.pop(seq, None)
            if conn is None or conn.closed:
                continue
            if outcome is None:
                self._close_conn(conn)
            else:
                self._relay_reply(conn, outcome, clock, time.monotonic())

    def _relay_reply(self, conn: _Conn, outcome: str, clock: Optional[float], now: float) -> None:
        frame = pc.RELAY_HDR.pack(pc.RELAY_MAGIC, 1, _tcp._RELAY_OUTCOMES.index(outcome),
                                  float(clock) if clock is not None else -1.0)
        self._queue_write(conn, frame, now)

    # -- buffered writes --------------------------------------------------
    def _queue_write(self, conn: _Conn, data: bytes, now: float) -> None:
        conn.outbuf = memoryview(data)
        conn.outsegs = None
        self._arm_write(conn, now)

    def _queue_segments(self, conn: _Conn, segments, now: float) -> None:
        """A segment-list response, sent as it is (header, payload,
        trailer), never joined."""
        conn.outbuf = None
        conn.outsegs = [memoryview(s).cast("B") for s in segments if len(s)]
        self._arm_write(conn, now)

    def _arm_write(self, conn: _Conn, now: float) -> None:
        conn.phase = _PH_WRITE
        conn.sent = 0
        conn.deadline = now + conn.write_timeout
        self._wheel.file(conn)
        try:
            self._sel.modify(conn.sock, selectors.EVENT_WRITE, conn)
        except (OSError, ValueError, KeyError):
            self._close_conn(conn)
            return
        self._on_writable(conn)  # a short response ends in one call

    def _written(self, conn: _Conn) -> None:
        """The response is out: count a whole frame, and close (which also
        gives back the reserved bytes and the admission slot)."""
        if conn.is_blob:
            with self._stats_lock:
                self._stats["frames"] += 1
        self._close_conn(conn)

    def _on_writable(self, conn: _Conn) -> None:
        if conn.outsegs is not None:
            self._write_segments(conn)
            return
        buf = conn.outbuf
        if buf is None:
            return
        progressed = False
        while conn.sent < len(buf):
            try:
                n = conn.sock.send(buf[conn.sent:])
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._close_conn(conn)
                return
            if n <= 0:
                break
            conn.sent += n
            progressed = True
        if conn.sent >= len(buf):
            self._written(conn)
        elif progressed:
            # A draining peer keeps its connection; a stalled one meets the
            # deadline on the wheel.
            conn.deadline = time.monotonic() + conn.write_timeout

    def _write_segments(self, conn: _Conn) -> None:
        """Drain ``conn.outsegs`` with non-blocking ``sendmsg`` (one call
        for every remaining segment; sent heads popped, a split head
        sliced), or ``send`` of the head where ``sendmsg`` is refused."""
        segs = conn.outsegs
        sendmsg = getattr(conn.sock, "sendmsg", None)
        progressed = False
        while segs:
            try:
                n = sendmsg(segs) if sendmsg is not None else conn.sock.send(segs[0])
            except (BlockingIOError, InterruptedError):
                break
            except OSError as exc:
                if sendmsg is not None and exc.errno in ingest._SENDMSG_UNSUPPORTED:
                    sendmsg = None
                    continue
                self._close_conn(conn)
                return
            if n <= 0:
                break
            conn.sent += n
            progressed = True
            while n > 0 and segs:
                head = segs[0]
                if n >= len(head):
                    n -= len(head)
                    segs.pop(0)
                else:
                    segs[0] = head[n:]
                    n = 0
        if not segs:
            self._written(conn)
        elif progressed:
            conn.deadline = time.monotonic() + conn.write_timeout

    # -- deadlines and teardown -------------------------------------------
    def _on_deadline(self, conn: _Conn, now: float) -> None:
        if conn.closed or conn.deadline > now:
            return
        if conn.phase in _INGEST_PHASES and self.flowctl.enabled and self.admission is not None:
            # A slow-loris eviction, counted as the threaded server counts it.
            self.admission.note_eviction()
        self._close_conn(conn, timed_out=True)

    def _close_conn(self, conn: _Conn, timed_out: bool = False) -> None:
        if conn.closed:
            return
        conn.closed = True
        self._wheel.unfile(conn)
        if conn.seq:
            self._relay_pending.pop(conn.seq, None)
        try:
            self._sel.unregister(conn.sock)
        except (OSError, ValueError, KeyError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        adm = self.admission
        if adm is not None and conn.reserved:
            adm.release_bytes(conn.reserved)
        hook = self.obs_serve_hook
        if conn.is_blob and hook is not None and conn.trace_id is not None:
            try:
                hook(conn.trace_id, conn.reserved, time.monotonic() - conn.t0)
            except Exception:  # observability never breaks a serve
                pass
        if adm is not None and conn.admitted:
            adm.release(conn.host)
        with self._stats_lock:
            st = self._stats
            st["open"] -= 1
            if timed_out:
                st["evicted"] += 1


def register_metrics(registry, server: ReactorPeerServer) -> None:
    """The reactor scheduler on a ``/metrics`` registry (``dpwa_reactor_*``)."""
    from dpwa_tpu_torch.obs.prometheus import Family

    def _collect():
        snap = server.reactor_snapshot()
        return [
            Family("dpwa_reactor_loop_lag_ms", "gauge",
                   "EWMA of event-loop iteration processing time.").sample(snap["loop_lag_ms"]),
            Family("dpwa_reactor_ready_depth", "gauge",
                   "Ready connections dispatched in the last iteration.").sample(
                snap["ready_depth"]),
            Family("dpwa_reactor_open_connections", "gauge",
                   "Connections currently registered with the loop.").sample(snap["open"]),
            Family("dpwa_reactor_peak_connections", "gauge",
                   "High-water mark of concurrently open connections.").sample(snap["peak_open"]),
            Family("dpwa_reactor_accepted_total", "counter",
                   "Connections admitted past flowctl at accept.").sample(snap["accepted"]),
            Family("dpwa_reactor_evicted_total", "counter",
                   "Connections closed by a timer-wheel deadline.").sample(snap["evicted"]),
            Family("dpwa_reactor_busy_shed_total", "counter",
                   "DPWB busy frames sent (admission + byte-ceiling sheds).").sample(
                snap["busy_shed"]),
            Family("dpwa_reactor_frames_served_total", "counter",
                   "Published blob frames fully written to a peer.").sample(snap["frames"]),
            Family("dpwa_reactor_relay_pending", "gauge",
                   "Relay probes in flight on the helper thread.").sample(snap["relay_pending"]),
        ]

    registry.register(_collect)
