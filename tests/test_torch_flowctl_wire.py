"""The port's flow control plane on the wire, against the reference's.

Each test names the test of ``tests/test_flowctl.py`` it mirrors; the
reference's objects run here on the same inputs (its own tests are red in
the driver's parallel runs, so their output is no ground truth).

- The ``DPWB`` shed crosses both ways: a reference fetcher and prober read
  a port server's shed as ``busy`` and the reverse, and a bad version is
  ``corrupt`` for both.
- The port server evicts a slow-loris request, sheds a send past the
  in-flight ceiling, and survives fuzzed requests with no admission slot
  leaked; the port fetcher classifies fuzzed frames within its budget and
  SLOW (bytes flowed) apart from TIMEOUT (none), as the reference does.
- The hedge: fired past the budget, the fallback's frame won and merged as
  a reference node merges it; no hedge inside the budget; a winner still
  guarded; a loser's late bytes never reach a later round's replica, and
  its receive lease goes back to the ring.
- Degrade shedding decides as the reference, and the snapshot carries the
  ``flowctl`` section and columns the reference's does.

Every socket binds port 0; nodes are wired with ``set_peer_port``.
"""

import dataclasses
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from dpwa_tpu.config import FlowctlConfig as RefFlowctlConfig
from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.device import reset_device_stats
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu.parallel.schedules import degrade_shed_draw as ref_degrade_shed_draw
from dpwa_tpu_torch.config import FlowctlConfig, make_local_config
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel import tcp
from dpwa_tpu_torch.parallel.schedules import build_schedule, degrade_shed_draw

HEDGE_FLOWCTL = dict(min_ms=40.0, max_ms=5000.0, quantile=1.0, margin=5.0, warmup=3, window=8)


@pytest.fixture(autouse=True)
def _socket_timeout():
    prev = socket.getdefaulttimeout()
    socket.setdefaulttimeout(10.0)
    try:
        yield
    finally:
        socket.setdefaulttimeout(prev)


class RawServer:
    """A listener running ``script(conn)`` on a thread a connection; the
    accepted sockets are kept in ``conns``."""

    def __init__(self, script):
        self.conns = []
        self._script = script
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            self.conns.append(conn)
            threading.Thread(target=self._run, args=(conn,), daemon=True).start()

    def _run(self, conn):
        try:
            self._script(conn)
        except OSError:
            pass

    def close(self):
        self._sock.close()
        for c in self.conns:
            try:
                c.close()
            except OSError:
                pass


def _read_request(conn):
    got = b""
    while len(got) < len(pc.BLOB_REQ):
        chunk = conn.recv(len(pc.BLOB_REQ) - len(got))
        if not chunk:
            break
        got += chunk
    return got


def _ephemeral(cfg):
    return dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))


def _ring(n, kind, **kw):
    """n transports of one package on port 0, wired to each other."""
    if kind == "ref":
        ts = [ref_tcp.TcpTransport(_ephemeral(ref_config(n, base_port=0, **kw)), f"node{i}")
              for i in range(n)]
    else:
        cfg = _ephemeral(make_local_config(n, **kw))
        ts = [tcp.TcpTransport(cfg, f"node{i}", device="cpu") for i in range(n)]
    for t in ts:
        for i, other in enumerate(ts):
            t.set_peer_port(i, other.port)
    return ts


def _close(ts):
    for t in ts:
        t.close()


def _settle(admission, active=0):
    deadline = time.monotonic() + 5.0
    while admission.snapshot()["active"] != active and time.monotonic() < deadline:
        time.sleep(0.01)


def _hog(server):
    """Occupy a one-slot server's slot: a partial request its worker waits on."""
    hog = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    hog.sendall(b"DP")
    _settle(server.admission, 1)
    return hog


def test_dpwb_shed_is_busy_both_ways():
    """Mirrors ``test_server_sheds_busy_at_the_connection_cap``,
    ``test_fetch_classifies_busy_and_rejects_bad_busy_version`` and
    ``test_probe_header_classifies_busy`` across the two packages."""
    cap = dict(max_connections=1, request_timeout_ms=3000)
    mine = tcp.PeerServer("127.0.0.1", 0, flowctl=FlowctlConfig(**cap))
    ref = ref_tcp.PeerServer("127.0.0.1", 0, flowctl=RefFlowctlConfig(**cap))
    vec = np.arange(8, dtype=np.float32)
    try:
        mine.publish(torch.from_numpy(vec), 1.0, 0.5)
        ref.publish(vec, 1.0, 0.5)
        for server in (mine, ref):
            hog = _hog(server)
            for fetch in (tcp.fetch_blob_full, ref_tcp.fetch_blob_full):
                got, outcome, *_ = fetch("127.0.0.1", server.port, 1000)
                assert got is None and outcome == Outcome.BUSY
            for probe in (tcp.probe_header_classified, ref_tcp.probe_header_classified):
                assert probe("127.0.0.1", server.port, 500) == (Outcome.BUSY, None)
            assert server.admission.snapshot()["sheds"]["connections"] == 4
            hog.close()
            _settle(server.admission)
            got, outcome, *_ = tcp.fetch_blob_full("127.0.0.1", server.port, 1000)
            assert outcome == Outcome.SUCCESS
            np.testing.assert_array_equal(got[0].numpy(), vec)
    finally:
        mine.close()
        ref.close()

    def bad_version(conn):
        _read_request(conn)
        conn.sendall(pc.BUSY_HDR.pack(pc.BUSY_MAGIC, 2, 25))
        conn.close()

    srv = RawServer(bad_version)
    try:
        for fetch in (tcp.fetch_blob_full, ref_tcp.fetch_blob_full):
            assert fetch("127.0.0.1", srv.port, 500)[1] == Outcome.CORRUPT
        for probe in (tcp.probe_header_classified, ref_tcp.probe_header_classified):
            assert probe("127.0.0.1", srv.port, 500) == (Outcome.CORRUPT, None)
    finally:
        srv.close()


def test_server_evicts_slow_loris_request():
    """Mirrors ``test_server_evicts_slow_loris_request``."""
    srv = tcp.PeerServer("127.0.0.1", 0, flowctl=FlowctlConfig(
        request_timeout_ms=300, min_ingest_bytes_per_s=1e6))
    try:
        srv.publish(torch.arange(8, dtype=torch.float32), 1.0, 0.5)
        loris = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        loris.sendall(b"D")
        loris.settimeout(5.0)
        t0 = time.monotonic()
        assert loris.recv(1) == b""  # cut at the request deadline
        assert time.monotonic() - t0 < 3.0
        loris.close()
        _settle(srv.admission)
        assert srv.admission.snapshot()["evictions"] == 1
        assert ref_tcp.fetch_blob_full("127.0.0.1", srv.port, 1000)[1] == Outcome.SUCCESS
    finally:
        srv.close()


def test_server_sheds_blob_past_inflight_bytes_ceiling():
    """Mirrors ``test_server_sheds_blob_past_inflight_bytes_ceiling``; the
    ceiling counts the whole frame, its trailer included, as the
    reference's does."""
    srv = tcp.PeerServer("127.0.0.1", 0, flowctl=FlowctlConfig(max_inflight_bytes=16))
    try:
        srv.publish(torch.arange(64, dtype=torch.float32), 1.0, 0.5, b"DPWM" + bytes(7))
        assert srv._payload_nbytes == pc.BLOB_HDR.size + 256 + 11
        for fetch in (tcp.fetch_blob_full, ref_tcp.fetch_blob_full):
            got, outcome, *_ = fetch("127.0.0.1", srv.port, 1000)
            assert got is None and outcome == Outcome.BUSY
        assert srv.admission.snapshot()["sheds"]["bytes"] == 2
    finally:
        srv.close()


def test_fetch_classifies_slow_when_bytes_flowed_timeout_when_none():
    """Mirrors the test of that name, with the reference's fetcher on the
    same servers."""
    def partial_then_stall(conn):
        _read_request(conn)
        conn.sendall(b"DPWA" + b"\x01" * 6)
        time.sleep(3.0)

    def accept_and_stall(conn):
        time.sleep(3.0)

    for script, want in ((partial_then_stall, Outcome.SLOW), (accept_and_stall, Outcome.TIMEOUT)):
        srv = RawServer(script)
        try:
            for fetch in (tcp.fetch_blob_full, ref_tcp.fetch_blob_full):
                _, outcome, latency, *_ = fetch("127.0.0.1", srv.port, 300)
                assert outcome == want and 0.2 < latency < 2.0
        finally:
            srv.close()


def _stall(conn):
    _read_request(conn)
    time.sleep(10.0)


def _hedge_ring(kind, frames, stall_port_of=None, **kw):
    ts = _ring(3, kind, schedule="ring", seed=5, timeout_ms=2000, flowctl=HEDGE_FLOWCTL, **kw)
    for i, t in enumerate(ts):
        t.publish(frames[i] if kind == "ref" else torch.from_numpy(frames[i]), 1.0, 0.1)
    if stall_port_of is not None:
        ts[0].set_peer_port(1, stall_port_of)
    for _ in range(3):  # warm on peer 1: the hedge launches at 40 ms
        ts[0]._estimator.observe(1, Outcome.SUCCESS, latency_s=0.04)
    return ts


def test_hedge_fires_and_the_fallback_frame_merges_as_the_reference_merges_it():
    """Mirrors ``test_hedge_fires_after_budget_and_fallback_wins``: a port
    node and a reference node, each with peer 1 stalled, hedge to the
    fallback (node 2), merge its frame with the same α to the same bits,
    cancel the stalled leg promptly (its server sees EOF) and charge it
    the soft ``slow`` outcome."""
    frames = [np.full(16, v, np.float32) for v in (0.25, 1.0, 2.0)]
    schedule = build_schedule(make_local_config(3, schedule="ring", seed=5))
    step = next(s for s in range(8) if schedule.partner(s, 0) == 1)
    merged, records = {}, {}
    for kind in ("port", "ref"):
        srv = RawServer(_stall)
        ts = _hedge_ring(kind, frames, srv.port)
        try:
            t0 = time.monotonic()
            local = frames[0].copy()
            out, alpha, partner = ts[0].exchange(local if kind == "ref" else torch.from_numpy(local),
                                                 1.0, 0.1, step)
            assert time.monotonic() - t0 < 2.0
            merged[kind] = (np.asarray(out), alpha, partner)
            records[kind] = {k: ts[0].last_fetch[k] for k in ("peer", "outcome", "hedged",
                                                               "hedge_winner")}
            assert ts[0].last_round["hedged"] and ts[0].last_round["hedge_winner"] == 2
            if kind == "port":
                # (The reference's first fallback draw compiles for longer
                # than the primary's deadline, which then lapses first.)
                snap = ts[0]._estimator.snapshot()
                assert (snap["hedges"], snap["hedge_wins"], snap["peers"][1]["slow"]) == (1, 1, 1)
                assert ts[0].scoreboard.snapshot()["peers"][1]["outcomes"] == {"slow": 1}
                srv.conns[0].settimeout(5.0)
                assert srv.conns[0].recv(1) == b""
        finally:
            srv.close()
            _close(ts)
    assert records["port"] == records["ref"] == {
        "peer": 2, "outcome": Outcome.SUCCESS, "hedged": True, "hedge_winner": 2}
    assert merged["port"][1:] == merged["ref"][1:]
    np.testing.assert_array_equal(merged["port"][0], merged["ref"][0])


def test_no_hedge_when_primary_answers_inside_budget():
    """Mirrors the test of that name."""
    ts = _ring(3, "port", schedule="ring", seed=5, timeout_ms=2000,
               flowctl=dict(HEDGE_FLOWCTL, min_ms=500.0))
    try:
        for i, t in enumerate(ts):
            t.publish(torch.full((16,), float(i)), 1.0, 0.1)
        for _ in range(3):
            ts[0]._estimator.observe(1, Outcome.SUCCESS, latency_s=0.5)
        assert ts[0].fetch(1, step=0) is not None
        assert "hedged" not in ts[0].last_fetch
        assert ts[0]._estimator.snapshot()["hedges"] == 0
    finally:
        _close(ts)


def test_hedge_winner_payload_still_passes_the_poison_guard():
    """Mirrors the test of that name: a NaN fallback wins the race and is
    charged ``poisoned``."""
    srv = RawServer(_stall)
    frames = [np.zeros(16, np.float32), np.ones(16, np.float32), np.full(16, np.nan, np.float32)]
    ts = _hedge_ring("port", frames, srv.port)
    try:
        assert ts[0].fetch(1, step=0) is None
        assert ts[0].last_fetch["outcome"] == Outcome.POISONED
        assert ts[0].last_fetch["hedged"] is True and ts[0].last_fetch["peer"] == 2
    finally:
        srv.close()
        _close(ts)


def _paced(frame, pause):
    """A server script sending ``frame`` in 256-byte chunks, ``pause`` apart."""
    def script(conn):
        _read_request(conn)
        for off in range(0, len(frame), 256):
            conn.sendall(frame[off:off + 256])
            time.sleep(pause)
    return script


def test_hedge_loser_late_bytes_never_land():
    """The primary streams a valid frame of 7.0s too slowly and loses to
    the fallback (2.0s).  Right after, the fallback's frames are fetched
    again from a paced server, each receive spanning the time the loser's
    stream would still run: a loser whose lease went back to the ring while
    its leg still received would write 7.0s into them.  Each lands exactly
    its bytes, and every lease is back in the ring at the end."""
    n = 4096
    srv = RawServer(_paced(tcp._frame(torch.full((n,), 7.0), 1.0, 0.1), 0.003))
    paced = RawServer(_paced(tcp._frame(torch.full((n,), 2.0), 2.0, 0.1), 0.001))
    frames = [np.full(n, v, np.float32) for v in (0.0, 1.0, 2.0)]
    # (Trust off: the screen would judge constant frames against a zero replica.)
    ts = _hedge_ring("port", frames, srv.port, trust={"enabled": False})
    try:
        t0 = ts[0]
        got = t0.fetch(1, step=0)
        assert t0.last_fetch["hedge_winner"] == 2
        assert torch.equal(got[0], torch.full((n,), 2.0))
        # The winner's buffer, back on top of the ring, held here: the next
        # fetches get the loser's buffer, if the ring has it, or a new one.
        held = t0.ring.lease(4 * n)
        t0.set_peer_port(2, paced.port)
        for step in range(1, 5):
            t0._estimator.evict_peer(2)  # cold: these fetches do not hedge
            got = t0.fetch(2, step=step)
            assert "hedged" not in t0.last_fetch
            assert got is not None and torch.equal(got[0], torch.full((n,), 2.0)), step
        del got
        held.release()
        deadline = time.monotonic() + 5.0
        while t0.ring.stats()["leased_bytes"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert t0.ring.stats()["leased_bytes"] == 0
    finally:
        srv.close()
        paced.close()
        _close(ts)


def test_fuzzed_frames_are_always_classified_within_budget():
    """Mirrors the test of that name (the port fetcher; each outcome also
    the reference fetcher's)."""
    vec = torch.arange(24, dtype=torch.float32)
    valid = tcp._frame(vec, 3.0, 0.25)
    rng = np.random.default_rng(0xF10C)
    cases = [valid[: int(rng.integers(0, len(valid)))] for _ in range(8)]
    for _ in range(8):
        buf = bytearray(valid)
        bit = int(rng.integers(0, len(buf) * 8))
        buf[bit // 8] ^= 1 << (bit % 8)
        cases.append(bytes(buf))
    for nbytes in (len(valid), 1 << 33, (1 << 34) + 1, 2**63 - 1):
        cases.append(pc.BLOB_HDR.pack(b"DPWA", 1, 0, 3.0, 0.25, nbytes) + valid[30:46])
    for i, data in enumerate(cases):
        def script(conn, data=data):
            _read_request(conn)
            if data:
                conn.sendall(data)
            conn.close()

        srv = RawServer(script)
        try:
            t0 = time.monotonic()
            got, outcome, _lat, _n = tcp.fetch_blob_full("127.0.0.1", srv.port, 400)
            assert time.monotonic() - t0 < 3.0, i
            assert outcome == ref_tcp.fetch_blob_full("127.0.0.1", srv.port, 400)[1], i
            assert outcome in (Outcome.SUCCESS, Outcome.CORRUPT, Outcome.SHORT_READ,
                               Outcome.TIMEOUT, Outcome.SLOW, Outcome.BUSY), i
            if outcome != Outcome.SUCCESS:
                assert got is None
        finally:
            srv.close()


def test_fuzzed_requests_never_kill_the_server():
    """Mirrors the test of that name: garbage requests, half of them reset
    mid-request; no admission slot leaks and a good fetch still works."""
    srv = tcp.PeerServer("127.0.0.1", 0, flowctl=FlowctlConfig(request_timeout_ms=300))
    rng = np.random.default_rng(0xBEEF)
    try:
        srv.publish(torch.arange(8, dtype=torch.float32), 1.0, 0.5)
        for _ in range(16):
            garbage = bytes(rng.integers(0, 256, size=int(rng.integers(0, 12)), dtype=np.uint8))
            with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as c:
                c.sendall(garbage)
                if rng.integers(0, 2):
                    c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        _settle(srv.admission)
        assert ref_tcp.fetch_blob_full("127.0.0.1", srv.port, 1000)[1] == Outcome.SUCCESS
        _settle(srv.admission)
        assert srv.admission.snapshot()["active"] == 0
    finally:
        srv.close()


def test_degraded_partner_rounds_are_partially_shed_as_the_reference_sheds_them():
    """Mirrors ``test_degraded_partner_rounds_are_partially_shed``: peer 1
    soft-degraded on node 0's scoreboard, each scheduled round with it is
    shed (to the same fallback) exactly where the reference's is."""
    decisions = {}
    for kind in ("port", "ref"):
        ts = _ring(4, kind, schedule="ring", seed=11, timeout_ms=300)
        try:
            t0 = ts[0]
            assert t0.config.flowctl.degrade_shed_fraction == 0.5
            for r in range(8):
                t0.scoreboard.record(1, Outcome.SLOW, round=r)
            decisions[kind] = [t0._resolve_partner(s) for s in range(8, 80)
                               if t0.schedule.partner(s, 0) == 1]
        finally:
            _close(ts)
    assert decisions["port"] == decisions["ref"]
    shed = [d for d in decisions["port"] if d[2]]
    assert shed and len(shed) < len(decisions["port"])
    assert all(partner not in (0, 1) for _, partner, _ in shed)
    for s in range(8, 80):
        assert degrade_shed_draw(11, s, 0) == ref_degrade_shed_draw(11, s, 0)


def _keys(doc, depth=2):
    if not isinstance(doc, dict) or depth == 0:
        return None
    return {str(k): _keys(v, depth - 1) for k, v in doc.items()}


def test_transport_snapshot_carries_flowctl_and_admission():
    """Mirrors the test of that name: after one fetch each, a port node's
    snapshot has the reference node's keys (the ``flowctl`` section with
    its admission counters, the per-peer flowctl columns) and the same
    estimator numbers but the latencies."""
    reset_device_stats()  # a reference snapshot gains "wire" once its device engine ran
    snaps = {}
    for kind in ("port", "ref"):
        ts = _ring(2, kind, schedule="ring", seed=3, timeout_ms=500)
        try:
            for i, t in enumerate(ts):
                vec = np.full(8, float(i), np.float32)
                t.publish(vec if kind == "ref" else torch.from_numpy(vec), 1.0, 0.1)
            assert ts[0].fetch(1, step=0) is not None
            snaps[kind] = ts[0].health_snapshot()
        finally:
            _close(ts)
    port, ref = snaps["port"], snaps["ref"]
    assert _keys(port, 4) == _keys(ref, 4)
    fc = port["flowctl"]
    assert fc["peers"][1]["samples"] == 1 and fc["admission"]["shed_total"] == 0
    for key in ("deadline_ms", "hedges", "hedge_wins", "busy", "slow"):
        assert port["peers"][1][key] == ref["peers"][1][key]
