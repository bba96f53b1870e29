"""The port's health plane against the reference's, on the CPU.

- The control draws (``fallback_draw``, ``backoff_jitter_draw``,
  ``donor_draw``) and ``Schedule.remap_partner`` (random healthy masks,
  with and without ``candidates=``, the self-pair when none is left)
  bit-equal to the reference's over a grid of (seed, step, me, n).
- The failure detector's and the scoreboard's snapshots equal to the
  reference's after identical seeded histories of fetch outcomes and
  probes (the pattern of ``tests/test_health.py``), and the reference's
  own scoreboard scenarios re-run on the port.
- The header probe of each package against the other's server and against
  the same faulty servers: the same classified outcome and clock.
- A 4-node ring, ``dpwa_tpu`` and ``dpwa_tpu_torch`` nodes mixed, health
  on and membership, trust and flowctl off, lock-step; node 3's server
  closes at round 3 and the node comes back at round 14 on a new port:
  each round's (sched_partner, partner, remapped, outcome), every merge,
  and each node's scoreboard snapshot (quarantine and readmission rounds,
  probes) equal to an all-reference group's.
- A transport at the default config runs every default-on plane of the
  reference (membership, trust, flowctl) and warns about nothing;
  ``healthz_port`` serves the health snapshot.

Every socket binds port 0 and peers are wired with ``set_peer_port``.
"""

import dataclasses
import json
import socket
import threading
import warnings

import numpy as np
import pytest
import torch

from dpwa_tpu.config import HealthConfig as RefHealthConfig
from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.device import reset_device_stats
from dpwa_tpu.health import detector as ref_detector
from dpwa_tpu.health import scoreboard as ref_scoreboard
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch.config import HealthConfig, make_local_config
from dpwa_tpu_torch.health import FailureDetector, Outcome, PeerState, Scoreboard, run_probe
from dpwa_tpu_torch.parallel import schedules
from dpwa_tpu_torch.parallel import tcp

UNPORTED_OFF = ("membership", "trust", "flowctl")
REF_UNPORTED_OFF = {p: {"enabled": False} for p in UNPORTED_OFF}


@pytest.fixture(autouse=True)
def _socket_timeout():
    prev = socket.getdefaulttimeout()
    socket.setdefaulttimeout(10.0)
    try:
        yield
    finally:
        socket.setdefaulttimeout(prev)


def _ephemeral(cfg):
    return dataclasses.replace(
        cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes)
    )


def _closed_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- the draws and the remap ----------------------------------------------

GRID = [(seed, step, me, n) for seed in (0, 3, 123456) for step in (0, 1, 7, 4096)
        for me in (0, 5) for n in (1, 2, 7, 64)]


@pytest.mark.parametrize("seed", [0, 3, 123456])
def test_control_draws_bit_equal_to_reference(seed):
    for _s, step, me, n in [g for g in GRID if g[0] == seed]:
        assert schedules.fallback_draw(seed, step, me, n) == int(
            ref_schedules.fallback_draw(seed, step, me, n))
        assert schedules.donor_draw(seed, step, me, n) == int(
            ref_schedules.donor_draw(seed, step, me, n))
    for peer in (0, 1, 5, 63):
        for streak in (1, 2, 3, 9):
            for jitter in (0, 1, 2, 7):
                assert schedules.backoff_jitter_draw(seed, peer, streak, jitter) == (
                    ref_schedules.backoff_jitter_draw(seed, peer, streak, jitter))


@pytest.mark.parametrize("n", [2, 3, 4, 6, 16])
@pytest.mark.parametrize("name", ["ring", "random"])
def test_remap_partner_bit_equal_to_reference(name, n):
    kw = dict(schedule=name, seed=n + 11)
    mine = schedules.build_schedule(make_local_config(n, **kw))
    ref = ref_schedules.build_schedule(ref_config(n, **kw))
    rng = np.random.default_rng(n)
    for step in range(12):
        me = int(rng.integers(n))
        partner = mine.partner(step, me)
        assert partner == ref.partner(step, me)
        mask = [bool(b) for b in rng.random(n) < 0.6]
        assert mine.remap_partner(step, me, partner, mask) == ref.remap_partner(
            step, me, partner, mask)
        view = sorted(int(p) for p in rng.choice(n, size=max(1, n // 2), replace=False))
        assert mine.remap_partner(step, me, partner, mask, candidates=view) == (
            ref.remap_partner(step, me, partner, mask, candidates=view))
    # No healthy candidate: the self-pair, the round skipped.
    assert mine.remap_partner(0, 0, 1, [True] + [False] * (n - 1)) == 0


# -- detector and scoreboard ------------------------------------------------

def _history(seed, n_peers, rounds):
    """A seeded outcome history: (kind, peer, outcome, latency, nbytes, round)."""
    rng = np.random.default_rng(seed)
    kinds = ["success"] * 6 + list(Outcome.FAILURES)
    out = []
    for r in range(rounds):
        for _ in range(int(rng.integers(1, 3))):
            peer = int(rng.integers(1, n_peers))
            if rng.random() < 0.2:
                out.append(("probe", peer, str(rng.choice(["success", "refused", "timeout"])),
                            None, 0, r))
            else:
                out.append(("fetch", peer, str(rng.choice(kinds)),
                            float(rng.uniform(1e-4, 0.2)), int(rng.integers(0, 10**6)), r))
    return out


def _replay(sb, history):
    states = []
    for kind, peer, outcome, lat, nbytes, r in history:
        if kind == "probe":
            sb.record_probe(peer, outcome, round=r)
        else:
            states.append(sb.record(peer, outcome, latency_s=lat, nbytes=nbytes, round=r))
        states.append((sb.is_quarantined(peer, r), sb.probe_due(peer, r), sb.healthy_mask(r)))
    return states


@pytest.mark.parametrize("seed", range(6))
def test_scoreboard_snapshots_equal_after_identical_histories(seed):
    n = 5
    cfg = dict(jitter_rounds=seed % 3, quarantine_base_rounds=1 + seed % 2)
    mine = Scoreboard(n, 0, HealthConfig(**cfg), seed=seed)
    ref = ref_scoreboard.Scoreboard(n, 0, RefHealthConfig(**cfg), seed=seed)
    history = _history(seed, n, 60)
    assert _replay(mine, history) == _replay(ref, history)
    for r in (59, 75, 200):
        assert json.dumps(mine.snapshot(r), sort_keys=True) == json.dumps(
            ref.snapshot(r), sort_keys=True)
        assert mine.probe_candidates(r) == ref.probe_candidates(r)
    assert any(p["quarantines"] for p in mine.snapshot()["peers"].values())


@pytest.mark.parametrize("seed", range(4))
def test_detector_snapshots_equal_after_identical_histories(seed):
    mine, ref = FailureDetector(ewma_alpha=0.3), ref_detector.FailureDetector(ewma_alpha=0.3)
    for _kind, peer, outcome, lat, nbytes, _r in _history(100 + seed, 4, 40):
        assert mine.observe(peer, outcome, lat, nbytes) == ref.observe(peer, outcome, lat, nbytes)
    for peer in range(4):
        assert mine.snapshot(peer) == ref.snapshot(peer)
        assert mine.phi(peer, 0.5) == ref.phi(peer, 0.5)
    with pytest.raises(ValueError):
        mine.observe(0, "no-such-outcome")


def test_scoreboard_quarantines_at_threshold():
    sb = Scoreboard(4, me=0, config=HealthConfig(), seed=7)
    assert sb.record(2, Outcome.TIMEOUT, round=0) == PeerState.SUSPECT
    assert not sb.is_quarantined(2, round=0)
    assert sb.record(2, Outcome.TIMEOUT, round=1) == PeerState.QUARANTINED
    mask = sb.healthy_mask(round=1)
    assert mask[2] is False and mask[0] and mask[1] and mask[3]
    release = sb._release_round[2]
    assert 1 + 4 <= release <= 1 + 4 + 2
    assert not sb.probe_due(2, round=release - 1) and sb.probe_due(2, round=release)


def test_scoreboard_probe_readmits_or_doubles_backoff():
    sb = Scoreboard(3, me=0, config=HealthConfig(jitter_rounds=0), seed=3)
    sb.record(1, Outcome.REFUSED, round=0)
    sb.record(1, Outcome.REFUSED, round=0)
    first = sb._release_round[1]
    assert not run_probe(lambda: False, sb, 1, round=first)
    assert sb._release_round[1] - first == 2 * first
    assert run_probe(lambda: True, sb, 1, round=sb._release_round[1])
    assert not sb.is_quarantined(1) and sb.detector.suspicion(1) == 0.0
    snap = sb.snapshot()["peers"][1]
    assert snap["state"] == PeerState.HEALTHY and snap["quarantined_rounds"] > 0
    assert (snap["probe_attempts"], snap["probe_successes"]) == (2, 1)


def test_soft_outcomes_degrade_and_never_quarantine():
    for sb in (Scoreboard(2, 0, HealthConfig(), seed=1),
               ref_scoreboard.Scoreboard(2, 0, RefHealthConfig(), seed=1)):
        for r in range(10):
            sb.record(1, Outcome.BUSY, round=r)
        assert sb.state(1) == PeerState.DEGRADED and not sb.is_quarantined(1)
        assert not sb.would_quarantine(1, Outcome.SLOW) and sb.would_quarantine(1, Outcome.REFUSED)


def test_eviction_and_readmission_match_reference():
    boards = (Scoreboard(4, 0, HealthConfig(), seed=2),
              ref_scoreboard.Scoreboard(4, 0, RefHealthConfig(), seed=2))
    logs = []
    for sb in boards:
        sb.record(1, Outcome.REFUSED, round=0)
        log = [sb.evict_peer(1, round=1), sb.is_evicted(1), sb.evicted_peers(), sb.tracked_peers()]
        log += [sb.probe_due(1, round=1 + 64), sb.healthy_mask(2)]
        sb.record_probe(1, True, round=70)
        log += [sb.state(1), sb.adopt_quarantine(2, round=71), sb.readmit(2, round=72),
                sb.quarantine_streak(2), sb.last_contact_map()]
        logs.append((log, json.dumps(sb.snapshot(80), sort_keys=True)))
    assert logs[0] == logs[1]


# -- the header probe ---------------------------------------------------------

def test_probe_header_classified_in_both_directions():
    vec = np.arange(1 << 12, dtype=np.float32)
    for srv in (ref_tcp.PeerServer("127.0.0.1", 0), tcp.PeerServer("127.0.0.1", 0)):
        try:
            # Nothing published: the server closes without a header.
            want = ("short_read", None)
            assert tcp.probe_header_classified("127.0.0.1", srv.port, 500) == want
            assert ref_tcp.probe_header_classified("127.0.0.1", srv.port, 500) == want
            if isinstance(srv, tcp.PeerServer):
                srv.publish(torch.from_numpy(vec), 9.0, 0.1)
            else:
                srv.publish(vec, 9.0, 0.1)
            for probe in (tcp.probe_header_classified, ref_tcp.probe_header_classified):
                assert probe("127.0.0.1", srv.port, 500) == ("success", 9.0)
            assert tcp.probe_header("127.0.0.1", srv.port) and tcp.probe_header_ex(
                "127.0.0.1", srv.port) == (True, 9.0)
        finally:
            srv.close()
    port = _closed_port()
    assert tcp.probe_header_classified("127.0.0.1", port, 200) == (
        ref_tcp.probe_header_classified("127.0.0.1", port, 200)) == ("refused", None)


FAULTY = {
    "busy": b"DPWB\x01\x19\x00",
    "busy_v2": b"DPWB\x02\x19\x00",
    "bad_magic": b"XXXX" + b"\0" * 30,
    "codec_header": tcp.pc.BLOB_HDR.pack(b"DPWA", 1, 4, 5.0, 0.0, 16),
    "bad_code": tcp.pc.BLOB_HDR.pack(b"DPWA", 1, 9, 5.0, 0.0, 16),
    "short_header": b"DPWA\x01",
    "silent": None,
}


class _Replier:
    """Accepts on port 0, reads each 5-byte request and answers ``reply``
    (None: stays silent until closed)."""

    def __init__(self, reply):
        self.reply = reply
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self._sock.settimeout(0.1)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._conns = []
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                continue
            conn.settimeout(5.0)
            self._conns.append(conn)
            try:
                conn.recv(5)
                if self.reply is not None:
                    conn.sendall(self.reply)
                    conn.close()
            except OSError:
                pass

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        assert not self._thread.is_alive()
        for c in self._conns:
            c.close()
        self._sock.close()


@pytest.mark.parametrize("fault", list(FAULTY))
def test_probe_outcomes_match_reference_against_faulty_servers(fault):
    server = _Replier(FAULTY[fault])
    try:
        got = tcp.probe_header_classified("127.0.0.1", server.port, 200)
        want = ref_tcp.probe_header_classified("127.0.0.1", server.port, 200)
        assert got == want
    finally:
        server.close()


# -- the transport: warnings, settings ----------------------------------------

def test_transport_at_the_defaults_runs_every_plane_and_warns_nothing():
    """Membership, trust and flowctl are ported: a node at the defaults
    runs all three, and a node with them switched off none, without a
    warning either way."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = tcp.TcpTransport(_ephemeral(make_local_config(2)), "node0", device="cpu")
        assert t.membership is not None and t.trust is not None
        assert t._estimator is not None and t.server.admission is not None
        t.close()
        t = tcp.TcpTransport(_ephemeral(make_local_config(2, disabled_planes=("flowctl",))),
                             "node0", device="cpu")
        assert t.membership is not None and t.trust is not None and t._estimator is None
        t.close()
        t = tcp.TcpTransport(_ephemeral(make_local_config(2, disabled_planes=UNPORTED_OFF)),
                             "node0", device="cpu")
        assert t.membership is None and t.trust is None and t._estimator is None
        assert t.server.admission is None
        t.close()


def test_healthz_port_serves_and_health_off_has_no_scoreboard():
    t = tcp.TcpTransport(_ephemeral(make_local_config(2, health={"healthz_port": 0})),
                         "node0", device="cpu")
    try:
        with socket.create_connection(("127.0.0.1", t.healthz.port), timeout=5) as c:
            c.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
            raw = b"".join(iter(lambda: c.recv(4096), b""))
        assert json.loads(raw.split(b"\r\n\r\n", 1)[1])["me"] == 0
    finally:
        t.close()
    cfg = _ephemeral(make_local_config(2, health={"enabled": False},
                                       disabled_planes=UNPORTED_OFF))
    t = tcp.TcpTransport(cfg, "node0", device="cpu")
    try:
        assert t.scoreboard is None
        assert t.health_snapshot() == {"me": 0, "round": 0, "peers": {}}
    finally:
        t.close()


# -- a 4-node mixed group with one node down ---------------------------------

def _group(kinds, seed=5):
    kw = dict(schedule="ring", interpolation="clock", factor=0.7, timeout_ms=1000, seed=seed)
    ref_cfg = _ephemeral(ref_config(len(kinds), base_port=0, **kw, **REF_UNPORTED_OFF))
    port_cfg = _ephemeral(make_local_config(len(kinds), **kw, disabled_planes=UNPORTED_OFF))
    nodes = []
    try:
        for i, kind in enumerate(kinds):
            nodes.append(_node(kind, ref_cfg, port_cfg, i))
        _wire(nodes)
    except BaseException:
        for t in nodes:
            t.close()
        raise
    return nodes, ref_cfg, port_cfg


def _node(kind, ref_cfg, port_cfg, i):
    if kind == "ref":
        return ref_tcp.TcpTransport(ref_cfg, f"node{i}")
    return tcp.TcpTransport(port_cfg, f"node{i}", device="cpu")


def _wire(nodes):
    for t in nodes:
        for i, other in enumerate(nodes):
            t.set_peer_port(i, other.port)


DOWN, BACK, ROUNDS = 3, 14, 30


def _down_group_run(kinds):
    """Lock-step rounds (every live node publishes, then every live node
    exchanges); node 3's server closes at round DOWN and the node is
    rebuilt on a new port at BACK.  Returns every round's decisions and
    merges, and each survivor's final scoreboard snapshot."""
    # A reference node's health snapshot gains a "wire" section once the
    # reference's device merge engine has served a round anywhere in this
    # process (``TcpTransport.health_snapshot``): start from a fresh engine,
    # as the reference's own tests do.
    reset_device_stats()
    nodes, ref_cfg, port_cfg = _group(kinds)
    rng = np.random.default_rng(0)
    vecs = [rng.standard_normal(257).astype(np.float32) for _ in kinds]
    log = []
    try:
        for r in range(ROUNDS):
            if r == DOWN:
                nodes[3].close()
            if r == BACK:
                nodes[3] = _node(kinds[3], ref_cfg, port_cfg, 3)
                _wire(nodes)
            live = [i for i in range(len(nodes)) if not DOWN <= r < BACK or i != 3]
            for i in live:
                v = vecs[i] if kinds[i] == "ref" else torch.from_numpy(vecs[i])
                nodes[i].publish(v, r + 1.0 + i, 0.5)
            for i in live:
                v = vecs[i] if kinds[i] == "ref" else torch.from_numpy(vecs[i])
                merged, alpha, _ = nodes[i].exchange(v, r + 1.0 + i, 0.5, r)
                vecs[i] = np.asarray(merged, np.float32).copy()
                lr = nodes[i].last_round
                log.append((r, i, lr["sched_partner"], lr["partner"], lr["remapped"],
                            lr["outcome"], float(alpha), vecs[i].view(np.int32).tobytes()))
        snaps = [json.loads(json.dumps(nodes[i].health_snapshot(), sort_keys=True))
                 for i in range(3)]
    finally:
        for t in nodes:
            t.close()
    return log, snaps


def _strip_latency(snap):
    for info in snap["peers"].values():
        for k in ("ewma_latency_ms", "ewma_throughput_mbps"):
            info.pop(k)
    return snap


@pytest.mark.parametrize("kinds", [("ref", "port", "port", "ref"), ("port", "ref", "ref", "port")])
def test_mixed_group_quarantines_remaps_and_readmits_as_reference(kinds):
    want_log, want_snaps = _down_group_run(("ref",) * 4)
    got_log, got_snaps = _down_group_run(kinds)
    assert [e[:6] for e in got_log] == [e[:6] for e in want_log]
    assert got_log == want_log  # α and every merge, bit for bit
    assert [_strip_latency(s) for s in got_snaps] == [_strip_latency(s) for s in want_snaps]
    # The fault did what it should: node 3 was quarantined, rounds were
    # remapped away from it, and it was readmitted after it came back.
    remapped = [e for e in want_log if e[4]]
    assert remapped and all(e[2] == 3 and e[3] != 3 for e in remapped)
    assert any(e[5] == "refused" for e in want_log)
    assert any(e[0] > BACK and e[3] == 3 and e[5] == "success" for e in want_log)
    peer3 = [s["peers"]["3"] for s in want_snaps]
    assert any(p["quarantines"] for p in peer3) and all(p["state"] == "healthy" for p in peer3)
