"""The reactor's parts against the reference's, on the CPU.

- the timer wheel files, re-files and expires connections as the
  reference's, deadlines far past the wheel's span included;
- the chaos reactor's write shaper allows the bytes the reference's allows
  at every instant, for gates, stalls and rates;
- a port reactor serves the codecs' frames (int8, top-k, shard) with the
  bytes of the port's threaded server, packs a lazily published state
  once, sheds a send past the in-flight ceiling as the reference's reactor
  does, answers a relay its guard blocks with ``refused`` unprobed, runs
  without flowctl, holds a chaos accept delay, and frees its port on close;
- the view's draws at candidate counts whose permutation takes two rounds
  of jax's shuffle.

Every socket binds port 0.
"""

import dataclasses
import socket
import time

import numpy as np
import pytest
import torch

from dpwa_tpu import config as ref_config
from dpwa_tpu.health import chaos as ref_chaos
from dpwa_tpu.parallel import reactor as ref_reactor
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch import config
from dpwa_tpu_torch.health import chaos
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.ops.quantize import TopkEncoder, encode_int8_payload
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel import reactor, schedules, tcp
from tests.test_torch_chaos import _raw_fetch


def _ephemeral(cfg):
    return dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))


class _Stub:
    """A connection as the wheel sees it."""

    def __init__(self, deadline):
        self.deadline = deadline
        self.slot = -1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timer_wheel_expires_as_the_reference(seed):
    """Random deadlines (some past the wheel's 6.4 s span, some refreshed
    after filing) filed in both wheels; at each tick both expire the same
    connections."""
    rng = np.random.default_rng(seed)
    mine, ref = reactor._TimerWheel(), ref_reactor._TimerWheel()
    mine.start(100.0)
    ref.start(100.0)
    conns = []
    for _ in range(60):
        d = 100.0 + float(rng.choice([rng.uniform(0, 2), rng.uniform(5, 20)]))
        a, b = _Stub(d), _Stub(d)
        mine.file(a)
        ref.file(b)
        conns.append((a, b))
    for a, b in conns[::3]:  # progress moved these deadlines on
        a.deadline = b.deadline = a.deadline + 1.5
    order = {id(b): i for i, (_a, b) in enumerate(conns)}
    index = {id(a): i for i, (a, _b) in enumerate(conns)}
    for now in np.arange(100.0, 125.0, 0.05):
        got = sorted(index[id(c)] for c in mine.expired(float(now)))
        want = sorted(order[id(c)] for c in ref.expired(float(now)))
        assert got == want, now
        assert all(conns[i][0].deadline <= now for i in got)
    assert all(a.slot == -1 for a, _b in conns)
    mine.unfile(conns[0][0])  # unfiling a fired connection is a no-op


@pytest.mark.parametrize("plan", [
    dict(start=0.3), dict(start=0.0, bps=5000.0),
    dict(start=0.1, bps=800.0), dict(start=0.0, stall_cut=100, stall_s=0.2),
    dict(start=0.05, bps=2000.0, stall_cut=33, stall_s=0.1),
])
def test_write_shaper_allows_what_the_reference_allows(plan):
    """Both shapers driven by the same (sent, now) sequence: the same
    allowance and the same next wake at every step."""
    args = (plan["start"], plan.get("bps", 0.0), plan.get("stall_cut", 0), plan.get("stall_s", 0.0))
    mine, ref = chaos._WriteShaper(*args), ref_chaos._WriteShaper(*args)
    total, sent = 300, 0
    for now in np.arange(0.0, 2.0, 0.01):
        got = mine.limit(sent, float(now), total)
        assert got == ref.limit(sent, float(now), total), now
        assert mine.next_wake(float(now)) == ref.next_wake(float(now))
        sent = min(total, max(sent, got))
    assert sent == total


@pytest.mark.parametrize("codec", ["int8", "topk", "shard"])
def test_reactor_serves_codec_frames_as_the_threaded_server(codec):
    """A codec's encoded body published with its code: the reactor and the
    threaded server send the same frame, digest trailer included."""
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(3000).astype(np.float32))
    if codec == "int8":
        body, code = encode_int8_payload(v, 0, 3.0, 0), pc.PAYLOAD_INT8_CHUNKED
    elif codec == "topk":
        body, code = TopkEncoder(0.05, "f32").encode(v, 0, 3.0, 0), pc.PAYLOAD_TOPK_DELTA
    else:
        cfg = config.make_local_config(2, shard={"k": 4})
        t = tcp.TcpTransport(_ephemeral(cfg), "node0", device="cpu")
        try:
            body, code = t.codec_body(v, 3.0)
        finally:
            t.close()
    servers = (reactor.ReactorPeerServer("127.0.0.1", 0), tcp.PeerServer("127.0.0.1", 0))
    try:
        for s in servers:
            s.publish(body, 3.0, 0.25, b"DPWM" + bytes(7), code)
        got = [_raw_fetch(s.port) for s in servers]
        assert got[0] == got[1] and pc.BLOB_HDR.unpack_from(got[0], 0)[2] == code
    finally:
        for s in servers:
            s.close()


def test_reactor_packs_a_lazy_state_once():
    calls = []
    srv = reactor.ReactorPeerServer("127.0.0.1", 0)
    try:
        blob = bytes(range(200)) * 5
        srv.publish_state(lambda: calls.append(1) or blob)
        for off in (0, 300, 900):
            got, outcome, *_ = tcp.fetch_state_chunk("127.0.0.1", srv.port, off, 256, 1000)
            assert outcome == Outcome.SUCCESS and bytes(got[0]) == blob[off:off + 256]
        assert calls == [1]
        srv.publish_state(blob)
        assert tcp.fetch_state_chunk("127.0.0.1", srv.port, 0, 8, 1000)[0][2] == 2  # generation
    finally:
        srv.close()


def test_reactor_sheds_past_the_inflight_ceiling_as_the_reference_reactor():
    """The ceiling counts the whole frame, trailer included; both reactors
    shed both fetchers' requests with ``DPWB`` and count a ``bytes`` shed."""
    mine = reactor.ReactorPeerServer("127.0.0.1", 0,
                                     flowctl=config.FlowctlConfig(max_inflight_bytes=16))
    ref = ref_reactor.ReactorPeerServer("127.0.0.1", 0,
                                        flowctl=ref_config.FlowctlConfig(max_inflight_bytes=16))
    try:
        mine.publish(torch.arange(64, dtype=torch.float32), 1.0, 0.5, b"DPWM" + bytes(7))
        ref.publish(np.arange(64, dtype=np.float32), 1.0, 0.5, digest=b"DPWM" + bytes(7))
        assert mine._payload == ref._payload
        for server in (mine, ref):
            for fetch in (tcp.fetch_blob_full, ref_tcp.fetch_blob_full):
                got, outcome, *_ = fetch("127.0.0.1", server.port, 1000)
                assert got is None and outcome == Outcome.BUSY
        assert (mine.admission.snapshot()["sheds"] == ref.admission.snapshot()["sheds"]
                == {"connections": 0, "tokens": 0, "bytes": 2})
        assert mine.reactor_snapshot()["busy_shed"] == ref.reactor_snapshot()["busy_shed"] == 2
    finally:
        mine.close()
        ref.close()


def test_reactor_relay_guard_refuses_without_a_probe():
    srv = reactor.ReactorPeerServer("127.0.0.1", 0)
    target = tcp.PeerServer("127.0.0.1", 0)
    try:
        target.publish(torch.ones(4), 7.0, 0.5)
        relay = pc.RELAY_REQ + pc.RELAY_BODY.pack(3, target.port, 200, 9) + b"127.0.0.1"
        assert pc.RELAY_HDR.unpack(_raw_fetch(srv.port, relay))[2:] == (0, 7.0)
        srv.relay_guard = lambda peer: peer == 3
        assert pc.RELAY_HDR.unpack(_raw_fetch(srv.port, relay))[2:] == (2, -1.0)  # refused
        assert srv.reactor_snapshot()["relay_pending"] == 0
    finally:
        srv.close()
        target.close()


def test_reactor_without_flowctl_serves_and_closes_idle_connections():
    """Flowctl off: no admission, no eviction counted, an idle request cut
    at the request budget all the same."""
    srv = reactor.ReactorPeerServer(
        "127.0.0.1", 0, flowctl=config.FlowctlConfig(enabled=False, request_timeout_ms=200))
    try:
        assert srv.admission is None
        srv.publish(torch.arange(8, dtype=torch.float32), 2.0, 0.5)
        got, outcome, *_ = ref_tcp.fetch_blob_full("127.0.0.1", srv.port, 1000)
        assert outcome == Outcome.SUCCESS and got[1] == 2.0
        with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as idle:
            idle.sendall(b"DP")
            t0 = time.monotonic()
            assert idle.recv(1) == b"" and time.monotonic() - t0 < 2.0
        snap = srv.reactor_snapshot()
        assert snap["evicted"] == 1 and snap["frames"] == 1
    finally:
        srv.close()


def test_chaos_reactor_holds_an_accept_delay():
    """An accept-delay window gates the frame's first byte by the delay, as
    the threaded chaos server's sleep does; outside it, no gate."""
    kw = dict(enabled=True, seed=2, accept_delay_windows=((0, 1, 2),), accept_delay_ms=150.0)
    srv = chaos.ChaosReactorPeerServer("127.0.0.1", 0,
                                       chaos.ChaosEngine(config.ChaosConfig(**kw), 0))
    try:
        for clock, gated in ((1.0, True), (2.0, False)):
            srv.publish(torch.arange(16, dtype=torch.float32), clock, 0.5)
            t0 = time.monotonic()
            got, outcome, *_ = tcp.fetch_blob_full("127.0.0.1", srv.port, 2000)
            waited = time.monotonic() - t0
            assert outcome == Outcome.SUCCESS and got[1] == clock
            assert (waited >= 0.14) == gated, waited
    finally:
        srv.close()


def test_reactor_close_frees_its_port_and_threads():
    srv = reactor.ReactorPeerServer("127.0.0.1", 0)
    port = srv.port
    held = socket.create_connection(("127.0.0.1", port))
    srv.close()
    held.close()
    assert not srv._thread.is_alive() and not srv._relay_thread.is_alive()
    again = reactor.ReactorPeerServer("127.0.0.1", port)  # the port is free again
    again.close()


def test_view_draws_bit_equal_where_the_shuffle_takes_two_rounds():
    """``prng.permutation`` runs a second sort round from 1,626 elements:
    the digest sample's permutation there, as jax draws it."""
    for n in (1625, 1626, 2000):
        assert np.array_equal(schedules.view_sample_draw(3, 11, 2, n),
                              ref_schedules.view_sample_draw(3, 11, 2, n)), n
