"""The port's reactor Rx server against the reference's, on the CPU.

Mirrors ``tests/test_reactor.py`` and the reactor cases of
``tests/test_fleet.py``; the reference's servers run here on the same
inputs (its own tests are red in the driver's parallel runs, so their
output is no ground truth):

- a port :class:`ReactorPeerServer` answers ``DPWA?``, ``DPWA@`` and
  ``DPWA!`` with the bytes of the port's threaded server and of the
  reference's reactor;
- garbage, short and reset requests close clean and the loop lives on; the
  ``DPWB`` shed at ``reactor_max_connections`` and the slow-loris eviction
  are counted as the reference's reactor counts them;
- :class:`ChaosReactorPeerServer` serves the threaded chaos server's bytes
  for every (seed, round) of each fault family, and honours the plan on
  STATE and RELAY;
- a 4-node ring of reactor nodes, mixed ref/port, merges bit for bit as a
  threaded port ring; the chaos server follows ``rx_server``; the
  ``reactor`` snapshot has the reference's keys; one loop serves 64
  fetching peers while 64 idle connections stay open.

Every socket binds port 0; nodes are wired with ``set_peer_port``.
"""

import concurrent.futures
import dataclasses
import socket
import struct
import time

import numpy as np
import pytest
import torch

from dpwa_tpu import config as ref_config
from dpwa_tpu.health import chaos as ref_chaos
from dpwa_tpu.parallel import reactor as ref_reactor
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch import config
from dpwa_tpu_torch.health import chaos
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel import tcp
from dpwa_tpu_torch.parallel.reactor import ReactorPeerServer
from tests.test_torch_chaos import SERVER_CONFIGS, _digest_bytes, _raw_fetch, _values

# Every simulated peer shares 127.0.0.1: open the per-host token bucket.
OPEN = dict(token_rate=1e9, token_burst=1e9)


@pytest.fixture(autouse=True)
def _socket_timeout():
    prev = socket.getdefaulttimeout()
    socket.setdefaulttimeout(10.0)
    try:
        yield
    finally:
        socket.setdefaulttimeout(prev)


def _servers(**fc):
    """The port's reactor, the port's threaded server and the reference's
    reactor, on port 0 at one flowctl config."""
    return (ReactorPeerServer("127.0.0.1", 0, flowctl=config.FlowctlConfig(**fc)),
            tcp.PeerServer("127.0.0.1", 0, flowctl=config.FlowctlConfig(**fc)),
            ref_reactor.ReactorPeerServer("127.0.0.1", 0, flowctl=ref_config.FlowctlConfig(**fc)))


def _publish(servers, v, clock, trailer=None):
    mine, threaded, ref = servers
    for s in (mine, threaded):
        s.publish(torch.from_numpy(v), clock, 0.5, trailer)
    ref.publish(v, clock, 0.5, digest=trailer)


def _settle(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _ephemeral(cfg):
    return dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))


@pytest.mark.parametrize("verb", ["blob", "state", "relay"])
def test_reactor_serves_the_threaded_and_reference_bytes(verb):
    """``DPWA?`` (a frame with its digest trailer, and nothing published),
    ``DPWA@`` (chunks of an eager and of a lazily packed state, past its
    end, none published) and ``DPWA!`` (a relayed probe of a live and of a
    closed target, with and without a host): the three servers send the
    same bytes."""
    servers = _servers(**OPEN)
    target = tcp.PeerServer("127.0.0.1", 0)
    closed = socket.socket()
    closed.bind(("127.0.0.1", 0))
    closed_port = closed.getsockname()[1]
    closed.close()
    try:
        target.publish(torch.ones(4), 42.0, 0.5)
        if verb == "blob":
            requests = [pc.BLOB_REQ]
            assert {_raw_fetch(s.port) for s in servers} == {b""}  # nothing published yet
            for r, trailer in ((1, None), (2, _digest_bytes())):
                _publish(servers, _values(200, r), float(r), trailer)
                got = [_raw_fetch(s.port) for s in servers]
                assert got[0] == got[1] == got[2] and len(got[0]) > 800
        elif verb == "state":
            requests = [pc.STATE_REQ + pc.STATE_REQ_BODY.pack(off, n)
                        for off, n in ((0, 64), (100, 1 << 20), (700, 64), (5000, 8))]
            assert len({_raw_fetch(s.port, requests[0]) for s in servers}) == 1  # none published
            blob = bytes(range(256)) * 3
            servers[0].publish_state(lambda: blob)  # packed at the first request
            servers[1].publish_state(blob)
            servers[2].publish_state(blob)
        else:
            requests = [pc.RELAY_REQ + pc.RELAY_BODY.pack(1, port, 200, 9) + b"127.0.0.1"
                        for port in (target.port, closed_port)]
            requests.append(pc.RELAY_REQ + pc.RELAY_BODY.pack(2, target.port, 50, 0))
        for request in requests:
            got = [_raw_fetch(s.port, request) for s in servers]
            assert got[0] == got[1] == got[2], request[:5]
            assert got[0]
        if verb == "relay":
            assert pc.RELAY_HDR.unpack(_raw_fetch(servers[0].port, requests[0]))[2:] == (0, 42.0)
        assert _settle(lambda: servers[0].reactor_snapshot()["open"] == 0)
    finally:
        for s in (*servers, target):
            s.close()


def _corpus(rng):
    """(label, request bytes, reset instead of a close): truncations,
    bit-flipped verbs, a lying relay host length, garbage."""
    cases = [("empty", b"", False), ("trunc-1", pc.BLOB_REQ[:1], False),
             ("trunc-4", pc.BLOB_REQ[:4], False),
             ("garbage-12", bytes(rng.integers(0, 256, 12, dtype=np.uint8)), False)]
    for verb in (pc.BLOB_REQ, pc.STATE_REQ, pc.RELAY_REQ):
        flipped = bytearray(verb)
        flipped[4] ^= 0x20
        cases.append((f"bitflip-{verb!r}", bytes(flipped), False))
    cases.append(("lying-relay-hostlen",
                  pc.RELAY_REQ + struct.pack("<HHIB", 1, 9, 200, 64) + b"127", False))
    cases.append(("trunc-state-body", pc.STATE_REQ + b"\x00\x01\x02", True))
    cases.append(("rst-mid-request", pc.BLOB_REQ[:3], True))
    return cases


def test_reactor_fuzz_corpus_closes_clean_and_loop_survives():
    """Mirrors ``test_reactor_fuzz_corpus_closes_clean_and_loop_survives``:
    every case ends in a close (at once for garbage, at the 300 ms request
    deadline for a stalled prefix), no admission slot leaks, and a good
    fetch of either package still succeeds."""
    srv = ReactorPeerServer("127.0.0.1", 0,
                            flowctl=config.FlowctlConfig(request_timeout_ms=300, **OPEN))
    try:
        srv.publish(torch.arange(8, dtype=torch.float32), 1.0, 0.5)
        for label, payload, rst in _corpus(np.random.default_rng(0xBEEF)):
            with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as c:
                if payload:
                    c.sendall(payload)
                if rst:
                    c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
                    continue
                c.settimeout(3.0)
                assert c.recv(16) == b"", label
        assert _settle(lambda: srv.admission.snapshot()["active"] == 0)
        for fetch in (tcp.fetch_blob_full, ref_tcp.fetch_blob_full):
            got, outcome, *_ = fetch("127.0.0.1", srv.port, 1000)
            assert outcome == Outcome.SUCCESS
            np.testing.assert_array_equal(np.asarray(got[0]), np.arange(8, dtype=np.float32))
        # Nothing published is a clean EOF, classified, never a hang.
        empty = ReactorPeerServer("127.0.0.1", 0)
        try:
            t0 = time.monotonic()
            res, outcome, *_ = tcp.fetch_blob_full("127.0.0.1", empty.port, 500)
            assert res is None and outcome in (Outcome.SHORT_READ, Outcome.TIMEOUT)
            assert time.monotonic() - t0 < 3.0
        finally:
            empty.close()
    finally:
        srv.close()


def test_reactor_sheds_dpwb_at_the_connection_cap():
    """``flowctl.reactor_max_connections`` caps the open connections (not
    ``max_connections``, the threaded server's threads): past it both
    reactors answer the same ``DPWB`` frame, read as ``busy`` by both
    fetchers, and count it alike; once the holders leave, fetches pass."""
    fc = dict(reactor_max_connections=2, max_connections=1, request_timeout_ms=3000, **OPEN)
    mine = ReactorPeerServer("127.0.0.1", 0, flowctl=config.FlowctlConfig(**fc))
    ref = ref_reactor.ReactorPeerServer("127.0.0.1", 0, flowctl=ref_config.FlowctlConfig(**fc))
    vec = np.arange(16, dtype=np.float32)
    try:
        mine.publish(torch.from_numpy(vec), 1.0, 0.5)
        ref.publish(vec, 1.0, 0.5)
        busy, counts = [], []
        for server in (mine, ref):
            holds = [socket.create_connection(("127.0.0.1", server.port)) for _ in range(2)]
            for h in holds:
                h.sendall(b"DP")
            assert _settle(lambda: server.admission.snapshot()["active"] == 2)
            busy.append(_raw_fetch(server.port))
            for fetch in (tcp.fetch_blob_full, ref_tcp.fetch_blob_full):
                got, outcome, *_ = fetch("127.0.0.1", server.port, 1000)
                assert got is None and outcome == Outcome.BUSY
            for h in holds:
                h.close()
            assert _settle(lambda: server.admission.snapshot()["active"] == 0)
            assert tcp.fetch_blob_full("127.0.0.1", server.port, 1000)[1] == Outcome.SUCCESS
            assert _settle(lambda: server.reactor_snapshot()["open"] == 0)
            snap = server.reactor_snapshot()
            counts.append((snap["busy_shed"], snap["accepted"], snap["peak_open"],
                           server.admission.snapshot()["sheds"]))
        assert busy[0] == busy[1] == pc.BUSY_HDR.pack(pc.BUSY_MAGIC, 1, 50)
        assert counts[0] == counts[1] == (3, 3, 3, {"connections": 3, "tokens": 0, "bytes": 0})
    finally:
        mine.close()
        ref.close()


def test_reactor_evicts_slow_loris_as_the_reference_reactor():
    """A request trickled slower than ``min_ingest_bytes_per_s`` is cut at
    its deadline by the timer wheel and counted as an eviction (admission)
    and a deadline close (the reactor), by both packages' reactors; the
    loop serves on."""
    fc = dict(request_timeout_ms=300, min_ingest_bytes_per_s=1e6)
    mine = ReactorPeerServer("127.0.0.1", 0, flowctl=config.FlowctlConfig(**fc))
    ref = ref_reactor.ReactorPeerServer("127.0.0.1", 0, flowctl=ref_config.FlowctlConfig(**fc))
    try:
        mine.publish(torch.arange(8, dtype=torch.float32), 1.0, 0.5)
        ref.publish(np.arange(8, dtype=np.float32), 1.0, 0.5)
        counts = []
        for server in (mine, ref):
            loris = socket.create_connection(("127.0.0.1", server.port), timeout=5)
            loris.sendall(b"D")
            t0 = time.monotonic()
            assert loris.recv(1) == b""
            assert time.monotonic() - t0 < 3.0
            loris.close()
            assert _settle(lambda: server.reactor_snapshot()["open"] == 0)
            assert ref_tcp.fetch_blob_full("127.0.0.1", server.port, 1000)[1] == Outcome.SUCCESS
            assert _settle(lambda: server.reactor_snapshot()["frames"] == 1)
            counts.append((server.admission.snapshot()["evictions"],
                           server.reactor_snapshot()["evicted"]))
        assert counts == [(1, 1), (1, 1)]
    finally:
        mine.close()
        ref.close()


@pytest.mark.parametrize("name", list(SERVER_CONFIGS))
def test_chaos_reactor_serves_the_threaded_chaos_bytes(name):
    """Mirrors ``tests/test_fleet.py``'s chaos identity matrix: for each
    (seed, round) the port's chaos reactor serves what the port's threaded
    chaos server and the reference's chaos reactor serve, content faults
    (byzantine, corrupt, truncate, drop, down) byte for byte, timing faults
    (delay, throttle, trickle, stall, accept delay) with the same bytes."""
    kw = dict(SERVER_CONFIGS[name], enabled=True, seed=4)
    mine = chaos.ChaosReactorPeerServer(
        "127.0.0.1", 0, chaos.ChaosEngine(config.ChaosConfig(**kw), 0))
    threaded = chaos.ChaosPeerServer("127.0.0.1", 0, chaos.ChaosEngine(config.ChaosConfig(**kw), 0))
    ref = ref_chaos.ChaosReactorPeerServer(
        "127.0.0.1", 0, ref_chaos.ChaosEngine(ref_config.ChaosConfig(**kw), 0))
    trailer = _digest_bytes()
    try:
        for r in range(1, 12):
            v = _values(96, r)
            for s in (mine, threaded):
                s.publish(torch.from_numpy(v), float(r), 0.5, trailer)
            ref.publish(v, float(r), 0.5, digest=trailer)
            got = _raw_fetch(mine.port)
            assert got == _raw_fetch(threaded.port) == _raw_fetch(ref.port), (name, r)
    finally:
        for s in (mine, threaded, ref):
            s.close()


def test_chaos_reactor_state_and_relay_honour_the_plan():
    """STATE chunks and relayed probes under the chaos reactor: a down
    window resets, a delay gates the reply, a relay across an injected
    partition reports ``refused`` unprobed, as the threaded chaos server."""
    kw = dict(enabled=True, seed=1, down_windows=((0, 3, 4),), partition_windows=(((0,), 5, 8),),
              delay_probability=1.0, delay_ms=30.0)
    mine = chaos.ChaosReactorPeerServer(
        "127.0.0.1", 0, chaos.ChaosEngine(config.ChaosConfig(**kw), 0))
    threaded = chaos.ChaosPeerServer("127.0.0.1", 0, chaos.ChaosEngine(config.ChaosConfig(**kw), 0))
    target = tcp.PeerServer("127.0.0.1", 0)
    try:
        target.publish(torch.ones(4), 42.0, 0.5)
        state = bytes(range(256)) * 3
        relay = pc.RELAY_REQ + pc.RELAY_BODY.pack(1, target.port, 200, 9) + b"127.0.0.1"
        for s in (mine, threaded):
            s.publish_state(state)
        for r in (1, 3, 5, 9):
            for s in (mine, threaded):
                s.publish(torch.full((8,), float(r)), float(r), 0.5)
            for request in (pc.STATE_REQ + pc.STATE_REQ_BODY.pack(100, 64), relay):
                t0 = time.monotonic()
                got = _raw_fetch(mine.port, request)
                waited = time.monotonic() - t0
                assert got == _raw_fetch(threaded.port, request), (r, request[:5])
                assert (got == b"") == (r == 3)
                assert r == 3 or waited >= 0.025  # the delay gate held the reply
        assert pc.RELAY_HDR.unpack(got)[2:] == (0, 42.0)
        mine.publish(torch.ones(8), 6.0, 0.5)
        assert pc.RELAY_HDR.unpack(_raw_fetch(mine.port, relay))[2] == 2  # refused
    finally:
        for s in (mine, threaded, target):
            s.close()


def _soak(kinds, rx, steps=8):
    """A 4-node ring lock-step (mirrors ``_soak``): ``kinds`` per node, each
    with ``rx`` as its Rx server; every node's replica after every round."""
    n = len(kinds)
    common = dict(schedule="ring", seed=5, factor=0.5, rx_server=rx)
    ref_cfg = _ephemeral(ref_config.make_local_config(n, base_port=0, **common))
    port_cfg = _ephemeral(config.make_local_config(n, **common))
    ts = []
    try:
        for i, kind in enumerate(kinds):
            ts.append(ref_tcp.TcpTransport(ref_cfg, f"node{i}") if kind == "ref"
                      else tcp.TcpTransport(port_cfg, f"node{i}", device="cpu"))
        for t in ts:
            for i, other in enumerate(ts):
                t.set_peer_port(i, other.port)
        vecs = [np.full(256, float(i + 1), np.float32) for i in range(n)]
        traj = []
        for step in range(steps):
            for i, t in enumerate(ts):
                t.publish(vecs[i], float(step + 1), 0.1)
            for i, t in enumerate(ts):
                merged, alpha, _ = t.exchange(vecs[i], float(step + 1), 0.1, step)
                if alpha != 0.0:
                    vecs[i] = np.asarray(merged, np.float32)
            traj.append([v.tobytes() for v in vecs])
        snaps = [t.health_snapshot().get("reactor") for t in ts]
        return traj, snaps, [type(t.server).__name__ for t in ts]
    finally:
        for t in ts:
            t.close()


def test_mixed_reactor_ring_is_byte_identical_to_threaded():
    """Mirrors ``test_reactor_soak_is_byte_identical_to_threaded`` across
    packages: a ref/port/ref/port ring of reactor nodes and a port ring of
    reactor nodes merge bit for bit as a threaded port ring; each reactor
    served its partner's fetches."""
    want, snaps, _ = _soak(("port",) * 4, "threaded")
    assert snaps == [None] * 4
    for kinds in (("ref", "port", "ref", "port"), ("port",) * 4):
        got, snaps, servers = _soak(kinds, "reactor")
        assert got == want, kinds
        assert servers == ["ReactorPeerServer"] * 4
        assert all(s["frames"] >= 1 and s["accepted"] >= s["frames"] for s in snaps)


def test_chaos_selects_matching_server_per_rx_backend():
    """Mirrors the test of that name: ``rx_server: reactor`` with chaos
    serves from :class:`ChaosReactorPeerServer`, the threaded default from
    :class:`ChaosPeerServer`, and the reactor alone from
    :class:`ReactorPeerServer`."""
    for kw, want in ((dict(rx_server="reactor", chaos=dict(enabled=True, seed=1)),
                      chaos.ChaosReactorPeerServer),
                     (dict(chaos=dict(enabled=True, seed=1)), chaos.ChaosPeerServer),
                     (dict(rx_server="reactor"), ReactorPeerServer)):
        cfg = _ephemeral(config.make_local_config(2, **kw))
        ts = [tcp.TcpTransport(cfg, f"node{i}", device="cpu") for i in range(2)]
        try:
            assert all(type(t.server) is want for t in ts), kw
        finally:
            for t in ts:
                t.close()


def test_reactor_snapshot_keys_equal_the_reference():
    """Mirrors ``test_reactor_subdocument_in_health_snapshot``: the
    ``reactor`` subdocument is there exactly when the reactor serves, with
    the reference reactor's keys, and counts the frame it served."""
    mine, threaded, ref = _servers()
    try:
        assert set(mine.reactor_snapshot()) == set(ref.reactor_snapshot())
    finally:
        for s in (mine, threaded, ref):
            s.close()
    for rx in ("reactor", "threaded"):
        cfg = _ephemeral(config.make_local_config(2, rx_server=rx, timeout_ms=500))
        ts = [tcp.TcpTransport(cfg, f"node{i}", device="cpu") for i in range(2)]
        try:
            for t in ts:
                for i, other in enumerate(ts):
                    t.set_peer_port(i, other.port)
            for i, t in enumerate(ts):
                t.publish(np.full(8, float(i + 1), np.float32), 1.0, 0.1)
            assert ts[0].fetch(1, step=0) is not None
            if rx == "threaded":
                assert "reactor" not in ts[1].health_snapshot()
                continue
            assert _settle(lambda: ts[1].health_snapshot()["reactor"]["frames"] == 1)
            served = ts[1].health_snapshot()["reactor"]
            assert served["accepted"] >= 1 and set(served) == set(ref_reactor.ReactorPeerServer
                                                                  .reactor_snapshot(ts[1].server))
        finally:
            for t in ts:
                t.close()


def test_reactor_serves_64_fetching_peers_beside_64_idle_ones():
    """Mirrors the reference's 256-peer tests at 64: one loop thread holds 64
    idle connections open and serves 64 fetching peers, two rounds each,
    every fetch a success; the counters settle to every frame served and
    nothing open."""
    srv = ReactorPeerServer("127.0.0.1", 0, flowctl=config.FlowctlConfig(**OPEN))
    vec = np.arange(4096, dtype=np.float32)
    try:
        srv.publish(torch.from_numpy(vec), 1.0, 0.1)
        idle = [socket.create_connection(("127.0.0.1", srv.port)) for _ in range(64)]
        try:
            assert _settle(lambda: srv.reactor_snapshot()["open"] == 64)
            with concurrent.futures.ThreadPoolExecutor(16) as pool:
                outcomes = list(pool.map(
                    lambda _: tcp.fetch_blob_full("127.0.0.1", srv.port, 5000)[1], range(128)))
            assert outcomes == [Outcome.SUCCESS] * 128
            assert srv.reactor_snapshot()["peak_open"] >= 65
        finally:
            for s in idle:
                s.close()
        assert _settle(lambda: srv.reactor_snapshot()["open"] == 0
                       and srv.reactor_snapshot()["frames"] == 128)
        snap = srv.reactor_snapshot()
        assert snap["accepted"] == 192 and snap["evicted"] == 0 and snap["busy_shed"] == 0
    finally:
        srv.close()
