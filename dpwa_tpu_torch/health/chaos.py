"""The deterministic chaos harness: seeded fault injection on the TCP path
(the port of :mod:`dpwa_tpu.health.chaos`, its threaded server).

:class:`ChaosPeerServer` wraps the Rx server and injects real wire faults,
so the fetching side exercises its own parsing, timeout and skip paths:

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
plan.  The served bytes of every fault are the reference's; a connection
with no fault drawn is served the published segments untouched.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Optional, Tuple

import numpy as np

from dpwa_tpu_torch.config import ChaosConfig, FlowctlConfig
from dpwa_tpu_torch.ops.quantize import n_chunks
from dpwa_tpu_torch.parallel import ingest
from dpwa_tpu_torch.parallel import protocol_constants as pc
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

    def publish(self, payload, clock: float, loss: float, digest: Optional[bytes] = None) -> None:
        # The integer publish clock is the round key.
        self._round = int(clock)
        self._srv.publish(payload, clock, loss, digest)
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
