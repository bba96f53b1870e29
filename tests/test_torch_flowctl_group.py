"""The flow control plane and the chaos harness in mixed groups over TCP,
``dpwa_tpu`` and ``dpwa_tpu_torch`` nodes together, on the CPU, against
all-reference groups.

Each test names the reference test it mirrors; those are red in the
driver's parallel runs (fixed ports), so their output is no ground truth:
the all-reference groups run here instead.

- The slow-peer scenario (``tests/test_flowctl.py``,
  ``test_acceptance_slow_peer_soft_degrades_never_dies``): four adapters in
  lock-step, nodes 1 and 2 of the port (node 2's chaos server trickles its
  frames at 2048 B/s for publish clocks [2, 26)), nodes 0 and 3 of the
  reference.  The decisions the reference's test asserts hold, and every
  node's (step, sched_partner, partner, remapped, outcome) timeline and
  node 2's health as each node sees it equal an all-reference group's.
  Its rerun twin (``test_acceptance_slow_peer_scenario_is_deterministic``)
  is marked slow, as the reference's is.
- The chaos harness's down window (``tests/test_health.py``,
  ``test_acceptance_chaos_kills_one_of_four_peers``) and wire faults
  (``test_chaos_ring_survives_wire_faults``) in mixed groups: timelines,
  merged replicas and scoreboards equal the reference's.
- ``GET /healthz`` on a port node serves the reference node's keys, with
  the ``flowctl``, ``trust`` and membership parts, and its sub-routes answer
  as the reference's (``test_healthz_serves_the_flowctl_subdocument``,
  ``tests/test_health.py::test_healthz_endpoint_serves_scoreboard_json``,
  ``tests/test_trust.py``'s and ``tests/test_membership.py``'s healthz
  tests).

Every socket binds port 0 and peers are wired with ``set_peer_port``.
"""

import dataclasses
import json
import socket
import time

import numpy as np
import pytest
import torch

from dpwa_tpu.adapters.tcp_adapter import DpwaTcpAdapter as RefAdapter
from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.device import reset_device_stats
from dpwa_tpu_torch.adapters.tcp_adapter import DpwaTcpAdapter
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.health.scoreboard import PeerState

VICTIM = 2
TRICKLE = (2, 26)  # publish clocks
STEPS = 30
VEC = 4096  # 16 KiB of f32: about 8 s at the trickle, far past the 400 ms budget
SLOW_CFG = dict(
    schedule="ring", seed=2, timeout_ms=400, health=dict(jitter_rounds=2),
    # min_ms 250 keeps warm deadlines far above loopback jitter: no hedge.
    flowctl=dict(min_ms=250.0),
    chaos=dict(enabled=True, seed=5, trickle_windows=[(VICTIM, *TRICKLE)],
               trickle_bytes_per_s=2048.0),
)
MIXED = ("ref", "port", "port", "ref")


@pytest.fixture(autouse=True)
def _socket_timeout():
    prev = socket.getdefaulttimeout()
    socket.setdefaulttimeout(10.0)
    try:
        yield
    finally:
        socket.setdefaulttimeout(prev)


def _ephemeral(cfg):
    return dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))


def _adapters(kinds, values, **kw):
    """One adapter a node, of the package ``kinds[i]`` says, all wired."""
    ref_cfg = _ephemeral(ref_config(len(kinds), base_port=0, **kw))
    port_cfg = _ephemeral(make_local_config(len(kinds), **kw))
    ads = []
    try:
        for i, kind in enumerate(kinds):
            ads.append(RefAdapter({"w": values[i].copy()}, f"node{i}", ref_cfg) if kind == "ref"
                       else DpwaTcpAdapter({"w": torch.from_numpy(values[i].copy())}, f"node{i}",
                                           port_cfg, device="cpu"))
        for a in ads:
            for i, other in enumerate(ads):
                a.transport.set_peer_port(i, other.transport.port)
    except BaseException:
        for a in ads:
            a.close()
        raise
    return ads


def _vector(a):
    return a.vector().numpy() if isinstance(a, DpwaTcpAdapter) else a._vec


def _lockstep(kinds, values, steps, watch, **kw):
    """Run the adapters ``steps`` lock-step rounds: each node's timeline of
    (step, sched_partner, partner, remapped, outcome), peer ``watch``'s
    state on each node's scoreboard after each round, the final replicas
    and the wall time."""
    reset_device_stats()  # a reference snapshot gains "wire" once its device engine ran
    ads = _adapters(kinds, values, **kw)
    timelines = [[] for _ in ads]
    states = [[] for _ in ads]
    t0 = time.monotonic()
    try:
        for step in range(steps):
            for i, a in enumerate(ads):
                a.update(loss=0.5)
                r = a.transport.last_round
                timelines[i].append((step, r["sched_partner"], r["partner"], r["remapped"],
                                     r["outcome"]))
                if i != watch:
                    states[i].append(a.transport.scoreboard.state(watch))
        wall = time.monotonic() - t0
        return timelines, states, [_vector(a).copy() for a in ads], wall
    finally:
        for a in ads:
            a.close()


def _slow_peer(kinds):
    values = [np.full(VEC, float(i) + 1.0, np.float32) for i in range(4)]
    return _lockstep(kinds, values, STEPS, VICTIM, **SLOW_CFG)


def _assert_slow_peer_decisions(timelines, states, wall):
    """What the reference's acceptance test asserts."""
    assert wall < 60.0, f"the soak took {wall:.1f} s: the budget did not bind"
    honest = [i for i in range(4) if i != VICTIM]
    assert any(PeerState.DEGRADED in states[i] for i in honest)
    for i in honest:
        assert PeerState.QUARANTINED not in states[i], f"node{i} quarantined the slow peer"
        for step, _sched, partner, _remapped, outcome in timelines[i]:
            if partner in honest and partner != i:
                assert outcome == Outcome.SUCCESS, (i, step, outcome)
            if partner == VICTIM and TRICKLE[0] <= step + 1 < TRICKLE[1]:
                assert outcome in (Outcome.SLOW, Outcome.BUSY, Outcome.SUCCESS), (i, step, outcome)
    shed = [r for i in honest for r in timelines[i] if r[1] == VICTIM and r[3]]
    assert shed, "no degraded round was shed to a fallback"
    assert all(r[2] != VICTIM and r[4] == Outcome.SUCCESS for r in shed)


def test_slow_peer_mixed_group_decides_as_an_all_reference_group():
    mixed = _slow_peer(MIXED)
    _assert_slow_peer_decisions(mixed[0], mixed[1], mixed[3])
    ref = _slow_peer(("ref",) * 4)
    assert mixed[0] == ref[0]
    assert mixed[1] == ref[1]
    for got, want in zip(mixed[2], ref[2]):
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_slow_peer_mixed_group_is_deterministic():
    """The rerun twin: identical seeds, identical timelines and health."""
    a, b = _slow_peer(MIXED), _slow_peer(MIXED)
    assert a[0] == b[0] and a[1] == b[1]


DOWN = (4, 14)  # the victim serves nothing for these publish clocks
KILL_CFG = dict(schedule="ring", seed=2, timeout_ms=400, health=dict(jitter_rounds=2),
                chaos=dict(enabled=True, seed=5, down_windows=[(VICTIM, *DOWN)]))


def test_chaos_down_window_mixed_group_decides_as_an_all_reference_group():
    """Node 2 (a port node) serves nothing for its clocks [4, 14): its
    partners quarantine it, never fetch it while quarantined, readmit it
    after the window, and every timeline, health trajectory and replica is
    the all-reference group's."""
    values = [np.full(32, float(i), np.float32) for i in range(4)]
    mixed = _lockstep(MIXED, values, STEPS, VICTIM, **KILL_CFG)
    ref = _lockstep(("ref",) * 4, values, STEPS, VICTIM, **KILL_CFG)
    assert mixed[0] == ref[0] and mixed[1] == ref[1]
    for got, want in zip(mixed[2], ref[2]):
        np.testing.assert_array_equal(got, want)
    neighbours = [i for i in range(4) if i != VICTIM
                  and any(r[1] == VICTIM for r in mixed[0][i])]
    for i in neighbours:
        q = [s for s, st in enumerate(mixed[1][i]) if st == PeerState.QUARANTINED]
        assert q and q[0] >= DOWN[0] - 1, (i, q)
        back = next(s for s in range(q[0], STEPS) if mixed[1][i][s] != PeerState.QUARANTINED)
        assert back >= DOWN[1] - 1
        assert all(r[2] != VICTIM for r in mixed[0][i][q[0] + 1:back])


@pytest.mark.parametrize("kinds", [("port", "ref"), ("ref", "port")])
def test_chaos_wire_faults_mixed_pair_decides_as_a_reference_pair(kinds):
    """Both nodes drop, truncate and corrupt their frames at seeded rounds:
    the fetchers' outcomes, the replicas and the scoreboards are a
    reference pair's, the vectors stay finite."""
    kw = dict(seed=9, timeout_ms=400, chaos=dict(
        enabled=True, seed=123, drop_probability=0.3, truncate_probability=0.25,
        corrupt_probability=0.25))
    values = [np.full(512, 1.0 + i, np.float32) for i in range(2)]
    mixed = _lockstep(kinds, values, 16, 1, **kw)
    ref = _lockstep(("ref", "ref"), values, 16, 1, **kw)
    assert mixed[0] == ref[0] and mixed[1] == ref[1]
    outcomes = {r[4] for tl in mixed[0] for r in tl}
    assert Outcome.SUCCESS in outcomes and outcomes - {Outcome.SUCCESS, None}
    for got, want in zip(mixed[2], ref[2]):
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)


def _get(port, path):
    with socket.create_connection(("127.0.0.1", port), timeout=5) as c:
        c.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        raw = b"".join(iter(lambda: c.recv(4096), b""))
    head, body = raw.split(b"\r\n\r\n", 1)
    assert head.startswith(b"HTTP/1.0 200 OK")
    return json.loads(body)


def _keys(doc, depth):
    """The document's keys ``depth`` levels down, a peer's id as ``peer``
    (the two nodes see each other)."""
    if not isinstance(doc, dict) or depth == 0:
        return type(doc).__name__
    return {("peer" if k.isdigit() else k): _keys(v, depth - 1) for k, v in doc.items()}


def test_healthz_on_a_port_node_serves_the_reference_keys():
    """A mixed pair with ``health.healthz_port: 0`` trains a few rounds;
    each node's ``/healthz`` (and an unknown path, ``/metrics``,
    ``/incidents`` and ``/flightdump``, which neither wires) has the same
    keys three levels down, ``flowctl``, ``trust`` and ``membership``
    included, and ``/flowctl``, ``/trust``, ``/membership`` and ``/wire``
    answer with the same keys."""
    values = [np.full(64, 1.0 + i, np.float32) for i in range(2)]
    reset_device_stats()
    ads = _adapters(("port", "ref"), values, seed=1, health={"healthz_port": 0})
    try:
        for _ in range(4):
            for a in ads:
                a.update(loss=0.5)
        docs = {}
        for a, kind in zip(ads, ("port", "ref")):
            port = a.transport.healthz.port
            docs[kind] = {p: _get(port, p) for p in ("/healthz", "/nowhere", "/metrics",
                                                    "/incidents", "/flightdump", "/flowctl",
                                                    "/trust", "/membership", "/wire")}
        for path in docs["port"]:
            assert _keys(docs["port"][path], 3) == _keys(docs["ref"][path], 3), path
        whole = docs["port"]["/healthz"]
        assert {"flowctl", "trust", "membership", "peers"} <= set(whole)
        assert whole["flowctl"]["admission"]["admitted"] >= 4
        assert docs["port"]["/wire"] == {"error": "wire plane disabled"}
        assert docs["port"]["/metrics"].keys() == whole.keys()
    finally:
        for a in ads:
            a.close()
