"""Hierarchical gossip on the TCP transport: 8-node rings of two islands of
4 (``pod-a`` node0-3, ``pod-b`` node4-7, leaders node3 and node4 at
``leader_seed`` 0), ref/port mixed, against all-reference rings on the
CPU.  Lock-step rounds at α 0.3 (at 0.5 every merge form agrees): each
round's partners, fetch decisions, α, served frame and merged replica,
the membership events, and the leader boards equal the reference's; every
frame carries a v2 digest.  Then the same ring under a partial view (the
island-first bootstrap), with island 1's leader closed at round 3, and a
flat ring whose frames stay on the v1 digest.  Every socket binds port 0
and peers are wired with ``set_peer_port``."""

import dataclasses
import hashlib
import json
import socket

import numpy as np
import pytest
import torch

from dpwa_tpu import config as ref_config
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch import config
from dpwa_tpu_torch.parallel import tcp

N, ROUNDS, DIM, CLOSE_AT, LEADER_B = 8, 9, 256, 3, 4
TWO_PODS = {"islands": [{"name": "pod-a", "nodes": [f"node{i}" for i in range(4)]},
                        {"name": "pod-b", "nodes": [f"node{i}" for i in range(4, 8)]}],
            "leader_seed": 0, "intra_rounds": 1}
# Deadlines no loaded CPU can lapse, so every outcome is the wire's, and a
# quick quarantine.
GROUP = dict(interpolation="constant", factor=0.3, timeout_ms=3000, seed=3,
             health={"jitter_rounds": 0, "quarantine_base_rounds": 1, "quarantine_max_rounds": 2},
             flowctl={"min_ms": 3000.0, "max_ms": 5000.0, "hedge": False,
                      "token_rate": 1e9, "token_burst": 1e9})
MIXED = ("ref", "port") * 4
ALL_REF = ("ref",) * N


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


def _ring(kinds, **kw):
    """Nodes of ``kinds`` under one config (GROUP with ``kw``), wired."""
    kw = {**GROUP, **kw}
    ref_cfg = _ephemeral(ref_config.make_local_config(len(kinds), base_port=0, **kw))
    port_cfg = _ephemeral(config.make_local_config(len(kinds), **kw))
    nodes = []
    try:
        for i, kind in enumerate(kinds):
            nodes.append(ref_tcp.TcpTransport(ref_cfg, f"node{i}") if kind == "ref"
                         else tcp.TcpTransport(port_cfg, f"node{i}", device="cpu"))
        for t in nodes:
            for i, other in enumerate(nodes):
                t.set_peer_port(i, other.port)
    except BaseException:
        for t in nodes:
            t.close()
        raise
    return nodes


def _digest_version(frame: bytes) -> int:
    """The version byte of the membership digest trailing ``frame``."""
    at = frame.rfind(b"DPWM")
    assert at > 0, "frame carries no digest"
    return frame[at + 4]


def _run(kinds, close_leader=False, **kw):
    """``ROUNDS`` lock-step rounds (every live node publishes, then every
    live node exchanges); island 1's leader closes at CLOSE_AT when asked.
    Every round's decisions, α, frame SHA-256 and merged replica; each
    node's membership events, its partial view as bootstrapped, its
    leaders at the end, and the digest versions of the frames served."""
    nodes = _ring(kinds, **kw)
    rng = np.random.default_rng(0)
    vecs = [rng.standard_normal(DIM).astype(np.float32) for _ in kinds]
    log, events, versions = [], [[] for _ in kinds], set()
    views = [None if t.membership is None or t.membership.partial is None else
             (sorted(t.membership.partial.active), sorted(t.membership.partial.passive))
             for t in nodes]
    try:
        for r in range(ROUNDS):
            if close_leader and r == CLOSE_AT:
                nodes[LEADER_B].close()
            live = [i for i in range(N) if not (close_leader and r >= CLOSE_AT and i == LEADER_B)]
            for i in live:
                v = vecs[i] if kinds[i] == "ref" else torch.from_numpy(vecs[i])
                nodes[i].publish(v, r + 1.0, 0.5)
                frame = nodes[i].server._payload
                versions.add(_digest_version(frame))
            for i in live:
                v = vecs[i] if kinds[i] == "ref" else torch.from_numpy(vecs[i])
                merged, alpha, _ = nodes[i].exchange(v, r + 1.0, 0.5, r)
                vecs[i] = np.asarray(merged, np.float32).copy()
                lr = nodes[i].last_round
                log.append((r, i, lr["sched_partner"], lr["partner"], lr["remapped"],
                            lr["outcome"], float(alpha),
                            hashlib.sha256(nodes[i].server._payload).hexdigest(),
                            vecs[i].view(np.int32).tobytes()))
                events[i].extend(nodes[i].pop_membership_events())
        leaders = [None if t.membership is None else t.membership.leader_board
                   for t in nodes]
        leaders = [None if b is None else b.leaders() for b in leaders]
        fetched = [dict(t.stats["digest_versions"]) for t, kind in zip(nodes, kinds)
                   if kind == "port"]
    finally:
        for t in nodes:
            t.close()
    return log, json.loads(json.dumps(events)), views, leaders, versions, fetched


def _assert_logs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:7] == w[:7], (g[:7], w[:7])
        assert g == w, g[:2]  # the frame and the merged replica


def _wide_fetches(log):
    """(round, node, partner) of every fetch across the two islands."""
    return [(r, i, p) for r, i, _, p, *_ in log if p != i and (i < 4) != (p < 4)]


@pytest.mark.parametrize("kinds", [MIXED, tuple(reversed(MIXED))])
def test_mixed_two_island_ring_equals_all_reference(kinds):
    """Three periods of the hier cycle: the partners, frames and merges of
    an all-reference ring, v2 digests on every frame, the boards agreeing
    on node3 and node4 at term 0, and only the leaders fetching across, in
    every wide slot."""
    want = _run(ALL_REF, topology=TWO_PODS)
    got = _run(kinds, topology=TWO_PODS)
    _assert_logs_equal(got[0], want[0])
    assert got[1] == want[1]
    assert got[3] == want[3] == [{0: 3, 1: 4}] * N
    assert got[4] == want[4] == {2}
    for fetched in got[5]:
        assert set(fetched) == {2} and fetched[2] > 0
    wide = _wide_fetches(got[0])
    assert wide == [(r, i, 7 - i) for r in (2, 5, 8) for i in (3, 4)]
    assert {entry[5] for entry in got[0] if entry[3] != entry[1]} == {"success"}
    assert {entry[5] for entry in got[0] if entry[3] == entry[1]} == {None}  # a self-pair


def test_partial_view_ring_bootstraps_island_first_like_the_reference():
    """The same ring with ``membership.view`` on (``active_size`` 2): each
    node's views start island-first as the reference's do, and the rounds
    equal the all-reference ring's."""
    member = {"view": {"enabled": True, "active_size": 2, "passive_size": 3, "digest_sample": 4,
                       "state_cap": 8}}
    want = _run(ALL_REF, topology=TWO_PODS, membership=member)
    got = _run(MIXED, topology=TWO_PODS, membership=member)
    assert got[2] == want[2]
    # node0's island mates first (1, 2), then the other leader and the rest.
    assert want[2][0] == ([1, 2], [3, 4, 5])
    assert want[2][5] == ([4, 6], [0, 3, 7])
    _assert_logs_equal(got[0], want[0])
    assert got[1] == want[1] and got[3] == want[3] and got[4] == want[4] == {2}


def test_closed_leader_ring_equals_all_reference():
    """Island 1's leader (node4) closed at round 3: node3's wide fetches and
    node5's and node7's intra fetches of it fail, quarantine it and remap,
    each decision the reference's."""
    # One hard failure quarantines for 4 rounds: each fetcher of node4 meets
    # it every third round, so its next turn is remapped.
    health = {"jitter_rounds": 0, "suspicion_threshold": 1.0, "quarantine_base_rounds": 4,
              "quarantine_max_rounds": 8}
    want = _run(ALL_REF, close_leader=True, topology=TWO_PODS, health=health)
    got = _run(MIXED, close_leader=True, topology=TWO_PODS, health=health)
    _assert_logs_equal(got[0], want[0])
    assert got[1] == want[1]
    assert got[3] == want[3]
    after = [entry for entry in want[0] if entry[0] >= CLOSE_AT and entry[2] == LEADER_B]
    assert after and {entry[1] for entry in after} == {3, 5, 7}
    assert [entry[4] for entry in after] == [False, False, False, True, True, True]  # remapped
    assert {entry[5] for entry in after[:3]} == {"refused"}
    assert {entry[5] for entry in after[3:]} == {"success"}


def test_flat_ring_frames_stay_on_the_v1_digest():
    """No ``topology:`` block: the ring schedule, v1 digests, and a mixed
    ring equal to an all-reference one."""
    want = _run(ALL_REF, schedule="ring")
    got = _run(MIXED, schedule="ring")
    _assert_logs_equal(got[0], want[0])
    assert got[1] == want[1]
    assert got[4] == want[4] == {1}
    assert got[3] == [None] * N
    for fetched in got[5]:
        assert set(fetched) == {1}
