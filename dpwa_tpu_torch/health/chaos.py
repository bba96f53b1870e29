"""The deterministic chaos harness: seeded fault injection on the TCP path
(the port of :mod:`dpwa_tpu.health.chaos`).

:class:`ChaosPeerServer` wraps the threaded Rx server, and
:class:`ChaosReactorPeerServer` is the reactor's chaos server
(``protocol.rx_server: reactor``); both inject real wire faults, so the
fetching side exercises its own parsing, timeout and skip paths:

- **drop**: close the connection before serving anything;
- **delay**: sleep ``delay_ms`` before serving;
- **throttle**: serve at ``throttle_bytes_per_s``;
- **truncate**: cut the frame mid-payload (a short read);
- **corrupt**: flip the frame's magic (a malformed header);
- **byzantine** content faults, drawn apart from the wire faults: the
  frame stays valid and its payload lies (sign-flip, scale, zero, a replay
  of an old frame; :func:`byzantine_frame`);
- **shaping**: ``trickle_windows`` and ``bandwidth_windows`` serve the
  whole frame slowly, a drawn stall freezes it mid-frame, an accept delay
  sleeps before the request is read;
- **down windows**: rounds ``[start, stop)`` in which a peer serves nothing;
- **partitions** and **link windows**: links the fetcher may not use
  (:meth:`ChaosEngine.link_blocked`, which the transport asks before it
  connects and the relay handler before it probes).

Each fault is drawn per (chaos seed, round, peer) on its own threefry
stream (:func:`~dpwa_tpu_torch.parallel.schedules.chaos_draw`), the round
being the integer publish clock (the training loops publish ``clock =
step``), so a seed replays the same faults, bit for bit the reference's
plan.  The served bytes of every fault are the reference's, and the two
servers' are equal (both go through :func:`mutate_frame` and
:func:`byzantine_frame`); a connection with no fault drawn is served the
published segments untouched.  The reactor cannot sleep, so its timing
faults are gates on its writes (:class:`_WriteShaper`), released at the
loop's 50 ms poll: the same classifications, coarser edges.
"""

from __future__ import annotations

import dataclasses
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from dpwa_tpu_torch.config import ChaosConfig, FlowctlConfig
from dpwa_tpu_torch.ops.quantize import n_chunks
from dpwa_tpu_torch.parallel import ingest
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel.reactor import ReactorPeerServer
from dpwa_tpu_torch.parallel.schedules import chaos_draw
from dpwa_tpu_torch.parallel.tcp import PeerServer
from dpwa_tpu_torch.utils import tags

# Priority when several wire faults are drawn in one round: one applies.
_PRIORITY = (
    ("drop", tags.CHAOS_KIND_DROP, "drop_probability"),
    ("truncate", tags.CHAOS_KIND_TRUNCATE, "truncate_probability"),
    ("corrupt", tags.CHAOS_KIND_CORRUPT, "corrupt_probability"),
    ("throttle", tags.CHAOS_KIND_THROTTLE, "throttle_probability"),
    ("delay", tags.CHAOS_KIND_DELAY, "delay_probability"),
)
_BYZ_PRIORITY = (
    ("sign", tags.CHAOS_KIND_BYZ_SIGN, "byzantine_sign_probability"),
    ("scale", tags.CHAOS_KIND_BYZ_SCALE, "byzantine_scale_probability"),
    ("replay", tags.CHAOS_KIND_BYZ_REPLAY, "byzantine_replay_probability"),
    ("zero", tags.CHAOS_KIND_BYZ_ZERO, "byzantine_zero_probability"),
)
# Plans kept per engine before the cache is cleared.
_PLAN_CACHE = 64
# Frames kept for the byzantine replay.
_HISTORY = 64


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The faults in effect for one (round, peer): a wire fault ``kind``
    (none, down, drop, delay, throttle, truncate, corrupt), a ``byzantine``
    one (none, sign, scale, replay, zero) and the shaping, which composes
    with both."""

    kind: str = "none"
    delay_s: float = 0.0
    throttle_bps: float = 0.0
    byzantine: str = "none"
    byz_scale: float = 0.0
    byz_replay_age: int = 0
    trickle_bps: float = 0.0
    stall_s: float = 0.0
    accept_delay_s: float = 0.0

    @property
    def faulty(self) -> bool:
        return (
            self.kind != "none" or self.byzantine != "none" or self.trickle_bps > 0.0
            or self.stall_s > 0.0 or self.accept_delay_s > 0.0
        )


def _in_window(windows, peer: int, round: int) -> bool:
    return any(p == peer and start <= round < stop for p, start, stop in windows)


class ChaosEngine:
    """Draws one peer's fault plan, round by round (cached: several
    fetchers may hit the same round)."""

    def __init__(self, config: ChaosConfig, peer: int):
        self.config = config
        self.peer = peer
        self._lock = threading.Lock()
        self._cache: dict = {}

    def down(self, round: int) -> bool:
        """Whether ``round`` lies in one of this peer's down windows."""
        return _in_window(self.config.down_windows, self.peer, round)

    def _drawn_side(self, round: int, peer: int) -> Optional[bool]:
        """``peer``'s side of the drawn partition at ``round``, or None when
        the round's block is not split (every process draws the same)."""
        cfg = self.config
        if cfg.partition_probability <= 0.0:
            return None
        block = round // cfg.partition_len_rounds
        if chaos_draw(cfg.seed, block, 0, tags.CHAOS_KIND_PARTITION) >= cfg.partition_probability:
            return None
        return chaos_draw(cfg.seed, block, peer, tags.CHAOS_KIND_PARTITION_SIDE) < 0.5

    def link_blocked(self, round: int, src: int, dst: int) -> bool:
        """Whether the directed link ``src`` → ``dst`` is cut at ``round``:
        by a partition window (both ways), a link window (that way) or a
        drawn partition."""
        if src == dst:
            return False
        cfg = self.config
        for group, start, stop in cfg.partition_windows:
            if start <= round < stop and (src in group) != (dst in group):
                return True
        for s, d, start, stop in cfg.link_windows:
            if s == src and d == dst and start <= round < stop:
                return True
        side_src = self._drawn_side(round, src)
        return side_src is not None and side_src != self._drawn_side(round, dst)

    def trickle_bps(self, round: int) -> float:
        """The trickle rate at ``round`` (0.0 outside this peer's windows)."""
        cfg = self.config
        return float(cfg.trickle_bytes_per_s) if _in_window(cfg.trickle_windows, self.peer, round) else 0.0

    def bandwidth_bps(self, round: int) -> float:
        """The flapping rate at ``round`` (0.0: unshaped): inside a
        bandwidth window, each block of ``bandwidth_block_rounds`` draws
        whether it is shaped and, if so, a rate between
        ``bandwidth_bps_min`` and ``bandwidth_bps_max``."""
        cfg = self.config
        if not _in_window(cfg.bandwidth_windows, self.peer, round):
            return 0.0
        block = round // cfg.bandwidth_block_rounds
        if (chaos_draw(cfg.seed, block, self.peer, tags.CHAOS_KIND_BANDWIDTH_FLAP)
                >= cfg.bandwidth_flap_probability):
            return 0.0
        frac = chaos_draw(cfg.seed, block, self.peer, tags.CHAOS_KIND_BANDWIDTH_RATE)
        return float(cfg.bandwidth_bps_min + frac * (cfg.bandwidth_bps_max - cfg.bandwidth_bps_min))

    def accept_delay_s(self, round: int) -> float:
        """The accept delay at ``round`` (0.0 outside this peer's windows)."""
        cfg = self.config
        return cfg.accept_delay_ms / 1000.0 if _in_window(cfg.accept_delay_windows, self.peer, round) else 0.0

    def plan(self, round: int) -> FaultPlan:
        if self.down(round):
            return FaultPlan(kind="down")
        with self._lock:
            cached = self._cache.get(round)
        if cached is not None:
            return cached
        cfg = self.config

        def first_drawn(priority) -> str:
            for kind, tag, field in priority:
                prob = getattr(cfg, field)
                if prob > 0.0 and chaos_draw(cfg.seed, round, self.peer, tag) < prob:
                    return kind
            return "none"

        wire_kind = first_drawn(_PRIORITY)
        byz = "none"
        if round >= cfg.byzantine_start_round and (
            not cfg.byzantine_peers or self.peer in cfg.byzantine_peers
        ):
            byz = first_drawn(_BYZ_PRIORITY)
        stall_s = 0.0
        if cfg.stall_probability > 0.0 and (
            chaos_draw(cfg.seed, round, self.peer, tags.CHAOS_KIND_STALL) < cfg.stall_probability
        ):
            stall_s = (chaos_draw(cfg.seed, round, self.peer, tags.CHAOS_KIND_STALL_LEN)
                       * cfg.stall_ms_max / 1000.0)
        # Flapping composes with a trickle window: the slower rate serves.
        trickle = self.trickle_bps(round)
        bandwidth = self.bandwidth_bps(round)
        if bandwidth > 0.0:
            trickle = bandwidth if trickle <= 0.0 else min(trickle, bandwidth)
        plan = FaultPlan(
            kind=wire_kind, delay_s=cfg.delay_ms / 1000.0, throttle_bps=cfg.throttle_bytes_per_s,
            byzantine=byz, byz_scale=cfg.byzantine_scale_factor,
            byz_replay_age=cfg.byzantine_replay_age, trickle_bps=trickle, stall_s=stall_s,
            accept_delay_s=self.accept_delay_s(round),
        )
        with self._lock:
            if len(self._cache) > _PLAN_CACHE:
                self._cache.clear()
            self._cache[round] = plan
        return plan


def mutate_frame(payload: bytes, kind: str) -> Optional[bytes]:
    """A wire fault applied to a frame; None serves nothing (drop, down).
    ``corrupt`` flips the magic; ``truncate`` cuts mid-payload (placed from
    the header's nbytes, so a trailer cannot absorb the cut)."""
    if kind in ("drop", "down"):
        return None
    if kind == "corrupt":
        return b"XXXX" + payload[4:]
    if kind == "truncate":
        nbytes = pc.BLOB_HDR.unpack_from(payload, 0)[5]
        body = min(int(nbytes), len(payload) - pc.BLOB_HDR.size)
        cut = pc.BLOB_HDR.size + max(1, body // 2)
        return payload[: min(cut, len(payload) - 1)]
    return payload


def _bf16_to_f64(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _f64_to_bf16(x: np.ndarray) -> np.ndarray:
    """float64 → bf16 bits as ``ml_dtypes`` converts: to float32 (round to
    nearest even), then to bf16 (round to nearest even, a NaN to the quiet
    NaN of its sign)."""
    bits = x.astype("<f4").view(np.uint32).astype(np.uint64)
    nearest = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    quiet_nan = ((bits >> 16) & 0x8000) | 0x7FC0
    return np.where(np.isnan(x), quiet_nan, nearest).astype("<u2")


def byzantine_frame(payload: bytes, kind: str, scale: float = 100.0) -> bytes:
    """The frame with its payload's content scaled (``sign``: by -1,
    ``zero``: by 0, else by ``scale``) and everything else, the header and
    every trailer, untouched: a valid frame that only the trust screen can
    object to.  Values are scaled in float64 and rounded back to the wire's
    type; the int8-chunked payload lies through its per-chunk scales, the
    top-k payload through its value block; a raw-bits (u16) or sharded
    payload is served unchanged."""
    with np.errstate(over="ignore", invalid="ignore"):  # inf and NaN scale as IEEE says
        return _byzantine_frame(payload, kind, scale)


def _byzantine_frame(payload: bytes, kind: str, scale: float) -> bytes:
    factor = {"sign": -1.0, "zero": 0.0}.get(kind, float(scale))
    _magic, _version, code, _clock, _loss, nbytes = pc.BLOB_HDR.unpack_from(payload, 0)
    head = pc.BLOB_HDR.size
    body = payload[head : head + nbytes]
    trailer = payload[head + nbytes :]

    def scaled_f32(raw: bytes) -> bytes:
        return (np.frombuffer(raw, "<f4") * np.float32(factor)).astype("<f4").tobytes()

    if code == pc.PAYLOAD_TOPK_DELTA:
        # u64 n | u32 k | u8 value_code | u32 idx[k] | values
        if len(body) < 13:
            return payload
        k = int(np.frombuffer(body[8:12], "<u4")[0])
        off = 13 + 4 * k
        span = 4 * k if body[12] == 0 else 4 * n_chunks(k)  # f32 values, or int8's scales
        body = body[:off] + scaled_f32(body[off : off + span]) + body[off + span :]
    elif code == pc.PAYLOAD_INT8_CHUNKED:
        if len(body) < 8:
            return payload
        span = 4 * n_chunks(int(np.frombuffer(body[:8], "<u8")[0]))
        body = body[:8] + scaled_f32(body[8 : 8 + span]) + body[8 + span :]
    elif code == pc.PAYLOAD_F32 or code == pc.PAYLOAD_F64:
        dt = "<f4" if code == pc.PAYLOAD_F32 else "<f8"
        body = (np.frombuffer(body, dt).astype(np.float64) * factor).astype(dt).tobytes()
    elif code == pc.PAYLOAD_BF16:
        body = _f64_to_bf16(_bf16_to_f64(np.frombuffer(body, "<u2")) * factor).tobytes()
    else:
        return payload
    return payload[:head] + body + trailer


def _send_paced(conn, data: bytes, bps: float) -> None:
    """Send ``data`` at ``bps`` bytes a second: chunks of about 50 ms of
    budget (1 byte to 4 KiB), each followed by its pause."""
    step = max(1, min(4096, int(bps * 0.05)))
    pause = step / bps
    for off in range(0, len(data), step):
        conn.sendall(data[off : off + step])
        time.sleep(pause)


def _send_shaped(conn, data: bytes, trickle_bps: float, stall_s: float) -> None:
    """A drawn stall (a third of the frame, the stall, the rest: bytes
    flowed, so the fetcher classifies ``slow``), then the rest at the
    trickle rate, or at once without one."""
    if stall_s > 0.0 and len(data) > 1:
        cut = max(1, len(data) // 3)
        conn.sendall(data[:cut])
        time.sleep(stall_s)
        data = data[cut:]
    if trickle_bps > 0.0:
        _send_paced(conn, data, trickle_bps)
    else:
        conn.sendall(data)


class ChaosPeerServer:
    """A :class:`~dpwa_tpu_torch.parallel.tcp.PeerServer` that applies the
    engine's plan to every connection (admission still gates the accept
    loop).  A fetch in a round with no fault drawn is served the published
    segments as the plain server serves them; a faulty one is joined into
    one byte string first.  The frames of earlier rounds are kept (joined)
    only when ``byzantine_replay_probability`` can draw a replay."""

    def __init__(self, host: str, port: int, engine: ChaosEngine,
                 flowctl: Optional[FlowctlConfig] = None):
        self.engine = engine
        self._round = 0
        self._history: Optional[Deque[Tuple[int, bytes]]] = (
            deque(maxlen=_HISTORY) if engine.config.byzantine_replay_probability > 0 else None
        )
        outer = self

        class _Server(PeerServer):
            def _handle(self, conn):
                outer._serve_with_faults(self, conn)

        self._srv = _Server(host, port, flowctl=flowctl)
        self.port = self._srv.port
        # Relayed probes honour the injected partitions too.
        self._srv.relay_guard = lambda target: engine.link_blocked(self._round, engine.peer, target)

    def publish(self, payload, clock: float, loss: float, digest: Optional[bytes] = None,
                code: Optional[int] = None, obs: Optional[bytes] = None,
                trace_id: Optional[str] = None) -> None:
        # The integer publish clock is the round key.
        self._round = int(clock)
        self._srv.publish(payload, clock, loss, digest, code, obs=obs, trace_id=trace_id)
        if self._history is not None:
            framed = self._srv._payload
            if framed is not None:
                self._history.append((self._round, framed))

    def publish_state(self, blob) -> None:
        self._srv.publish_state(blob)

    @property
    def admission(self):
        """The wrapped server's admission controller."""
        return self._srv.admission

    @property
    def _payload(self) -> Optional[bytes]:
        return self._srv._payload

    def _serve_with_faults(self, srv: PeerServer, conn) -> None:
        plan = self.engine.plan(self._round)
        if plan.accept_delay_s > 0.0:
            # The fetcher's deadline runs with nothing received: a timeout.
            time.sleep(plan.accept_delay_s)
        if plan.kind in ("down", "drop"):
            return  # the worker closes: a reset or a short read
        req = ingest.recv_exact_into(conn, len(pc.BLOB_REQ))
        if req == pc.RELAY_REQ:
            if plan.kind == "delay":
                time.sleep(plan.delay_s)
            srv._handle_relay(conn)
            return
        if req == pc.STATE_REQ:
            body = ingest.recv_exact_into(conn, pc.STATE_REQ_BODY.size)
            offset, max_chunk = pc.STATE_REQ_BODY.unpack(body)
            if plan.kind == "delay":
                time.sleep(plan.delay_s)
            srv._handle_state(conn, offset, max_chunk)
            return
        if req != pc.BLOB_REQ:
            return
        with srv._lock:
            segments = srv._segments
        if segments is None:
            return
        if not plan.faulty:
            ingest.sendall_segments(conn, segments)
            return
        # Content first, then the wire: a lying frame can still be slow.
        payload = b"".join(bytes(s) for s in segments)
        if plan.byzantine == "replay":
            payload = self._replay_frame(payload, plan.byz_replay_age)
        elif plan.byzantine != "none":
            payload = byzantine_frame(payload, plan.byzantine, plan.byz_scale)
        if plan.kind == "delay":
            time.sleep(plan.delay_s)
            _send_shaped(conn, payload, plan.trickle_bps, plan.stall_s)
        elif plan.kind == "throttle":
            # A trickle window outranks the drawn throttle rate.
            _send_shaped(conn, payload, plan.trickle_bps or plan.throttle_bps, plan.stall_s)
        else:
            mutated = mutate_frame(payload, plan.kind)
            if mutated is not None:
                _send_shaped(conn, mutated, plan.trickle_bps, plan.stall_s)

    def _replay_frame(self, current: bytes, age: int) -> bytes:
        """The newest kept frame at least ``age`` rounds old, else the
        oldest kept frame older than this round, else ``current``."""
        history = self._history or ()
        stale = [f for r, f in history if r <= self._round - age]
        if stale:
            return stale[-1]
        older = [f for r, f in history if r < self._round]
        return older[0] if older else current

    def close(self) -> None:
        self._srv.close()


class _WriteShaper:
    """The chaos timing of one reactor response, as a byte allowance the
    loop enforces (the reactor cannot sleep): a start gate (no byte before
    ``start_t``: the accept delay and the delay fault), an optional stall
    (a third of the frame, a freeze of ``stall_s``, the rest: the threaded
    :func:`_send_shaped`'s shape) and a linear rate of ``bps`` bytes a
    second (throttle and trickle).  Content is never touched here."""

    __slots__ = ("start_t", "bps", "stall_cut", "stall_s", "stall_until")

    def __init__(self, start_t: float, bps: float = 0.0, stall_cut: int = 0,
                 stall_s: float = 0.0):
        self.start_t = start_t
        self.bps = bps
        self.stall_cut = stall_cut
        self.stall_s = stall_s
        self.stall_until: Optional[float] = None

    def limit(self, sent: int, now: float, total: int) -> int:
        """The byte offset the wire may reach at ``now`` (monotone in
        ``now``; the stall's anchor is set when the burst reaches the
        cut)."""
        if now < self.start_t:
            return 0
        if self.stall_cut:
            if sent < self.stall_cut:
                return self.stall_cut
            if self.stall_until is None:
                self.stall_until = now + self.stall_s
                return sent
            if now < self.stall_until:
                return sent
            if self.bps > 0.0:
                return self.stall_cut + max(1, int((now - self.stall_until) * self.bps))
            return total
        if self.bps > 0.0:
            return max(1, int((now - self.start_t) * self.bps))
        return total

    def next_wake(self, now: float) -> float:
        """When the gated write is driven again."""
        if now < self.start_t:
            return self.start_t
        if self.stall_until is not None and now < self.stall_until:
            return self.stall_until
        return now + 0.05


class ChaosReactorPeerServer(ReactorPeerServer):
    """Chaos under the reactor (``protocol.rx_server: reactor`` and
    ``chaos.enabled``).  Content faults (byzantine, corrupt, truncate,
    drop, down windows) go through the threaded :class:`ChaosPeerServer`'s
    pure mutators, so for a (seed, round, peer) the two servers serve the
    same bytes; a drop or a down window aborts with a reset, as the
    threaded handler's close with the request unread does.  Timing faults
    gate the loop's writes per connection (:class:`_WriteShaper`)."""

    def __init__(self, host: str, port: int, engine: ChaosEngine,
                 flowctl: Optional[FlowctlConfig] = None):
        self.engine = engine
        self._round = 0
        self._history: Optional[Deque[Tuple[int, bytes]]] = (
            deque(maxlen=_HISTORY) if engine.config.byzantine_replay_probability > 0 else None
        )
        # Loop thread only: the shaped connections and the gated ones
        # waiting for a release, (wake time, conn).  Made before the base
        # constructor starts the loop.
        self._shapers: Dict[object, _WriteShaper] = {}
        self._deferred: List[Tuple[float, object]] = []
        # Relayed probes honour the injected partitions too.
        self.relay_guard = lambda target: engine.link_blocked(self._round, engine.peer, target)
        super().__init__(host, port, flowctl=flowctl)

    def publish(self, payload, clock: float, loss: float, digest: Optional[bytes] = None,
                code: Optional[int] = None, obs: Optional[bytes] = None,
                trace_id: Optional[str] = None) -> None:
        # The integer publish clock is the round key.
        self._round = int(clock)
        super().publish(payload, clock, loss, digest, code, obs=obs, trace_id=trace_id)
        if self._history is not None:
            framed = self._payload
            if framed is not None:
                self._history.append((self._round, framed))

    _replay_frame = ChaosPeerServer._replay_frame

    def _abort_conn(self, conn) -> None:
        """Close with a reset, not a FIN: the threaded handler closes with
        the request unread, which resets."""
        try:
            conn.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        except OSError:
            pass
        self._close_conn(conn)

    def _gate(self, conn, plan: FaultPlan, now: float) -> None:
        """Gate a STATE or RELAY reply by the accept delay and a delay
        fault."""
        gate = plan.accept_delay_s + (plan.delay_s if plan.kind == "delay" else 0.0)
        if gate > 0.0:
            self._shapers[conn] = _WriteShaper(now + gate)

    def _serve_blob(self, conn, now: float) -> None:
        plan = self.engine.plan(self._round)
        if plan.kind in ("down", "drop"):
            self._abort_conn(conn)
            return
        if not plan.faulty:
            super()._serve_blob(conn, now)
            return
        payload = self._payload
        if payload is None:
            self._close_conn(conn)
            return
        # Content first, then the wire, as the threaded server composes them.
        if plan.byzantine == "replay":
            payload = self._replay_frame(payload, plan.byz_replay_age)
        elif plan.byzantine != "none":
            payload = byzantine_frame(payload, plan.byzantine, plan.byz_scale)
        bps = plan.trickle_bps
        if plan.kind == "throttle":
            bps = plan.trickle_bps or plan.throttle_bps  # a trickle window outranks it
        elif plan.kind != "delay":
            payload = mutate_frame(payload, plan.kind)
        adm = self.admission
        if adm is not None and not adm.reserve_bytes(len(payload)):
            self._queue_busy(conn, self.flowctl.busy_retry_ms, now)
            return
        conn.reserved = len(payload)
        conn.is_blob = True
        start_t = now + plan.accept_delay_s + (plan.delay_s if plan.kind == "delay" else 0.0)
        stall_cut = max(1, len(payload) // 3) if plan.stall_s > 0.0 and len(payload) > 1 else 0
        if start_t > now or bps > 0.0 or stall_cut:
            self._shapers[conn] = _WriteShaper(start_t, bps, stall_cut, plan.stall_s)
        self._queue_write(conn, payload, now)

    def _serve_state(self, conn, offset: int, max_chunk: int, now: float) -> None:
        plan = self.engine.plan(self._round)
        if plan.kind in ("down", "drop"):
            self._abort_conn(conn)
            return
        self._gate(conn, plan, now)
        super()._serve_state(conn, offset, max_chunk, now)

    def _start_relay(self, conn, host: str, now: float) -> None:
        plan = self.engine.plan(self._round)
        if plan.kind in ("down", "drop"):
            self._abort_conn(conn)
            return
        self._gate(conn, plan, now)  # gates the reply, not the probe
        super()._start_relay(conn, host, now)

    def _on_writable(self, conn) -> None:
        sh = self._shapers.get(conn)
        if sh is None:
            super()._on_writable(conn)
            return
        if conn.outsegs is not None:
            # A shaped write meters one buffer by offset: join the segments
            # (a copy off the unfaulted path).
            conn.outbuf = memoryview(b"".join(bytes(s) for s in conn.outsegs))
            conn.outsegs = None
        buf = conn.outbuf
        if buf is None:
            return
        now = time.monotonic()
        limit = min(len(buf), sh.limit(conn.sent, now, len(buf)))
        progressed = False
        while conn.sent < limit:
            try:
                n = conn.sock.send(buf[conn.sent:limit])
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
            return
        if progressed:
            conn.deadline = time.monotonic() + conn.write_timeout
        if conn.sent >= limit:
            # Gated: drop write interest (a writable socket would spin the
            # loop) and wake at the release; reading stays on, so an EOF
            # still tears the connection down.
            wake = sh.next_wake(now)
            if conn.deadline < wake + conn.write_timeout:
                conn.deadline = wake + conn.write_timeout  # a long gate is no stall
                self._wheel.file(conn)
            try:
                self._sel.modify(conn.sock, selectors.EVENT_READ, conn)
            except (OSError, ValueError, KeyError):
                self._close_conn(conn)
                return
            self._deferred.append((wake, conn))

    def _drain_relay_done(self) -> None:
        # Once a loop iteration: also the gated writes' release pump.
        super()._drain_relay_done()
        if not self._deferred:
            return
        now = time.monotonic()
        ready = [c for t, c in self._deferred if t <= now]
        if not ready:
            return
        self._deferred = [(t, c) for t, c in self._deferred if t > now and not c.closed]
        for conn in ready:
            if conn.closed:
                continue
            try:
                self._sel.modify(conn.sock, selectors.EVENT_WRITE, conn)
            except (OSError, ValueError, KeyError):
                self._close_conn(conn)
                continue
            self._on_writable(conn)

    def _close_conn(self, conn, timed_out: bool = False) -> None:
        self._shapers.pop(conn, None)
        super()._close_conn(conn, timed_out=timed_out)
