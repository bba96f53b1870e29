"""The partial view in groups of nodes, the port's against the reference's,
on the CPU.

Mirrors ``tests/test_partial_view.py``'s identity and protection tests;
the reference's objects run here on the same inputs (its own tests are red
in the driver's parallel runs, so their output is no ground truth):

- the identity guarantee: with ``digest_sample >= N``, ``state_cap >= N``
  and ``active_size >= N - 1`` every frame a port manager publishes, and
  every event, is the global view's across a dead eviction
  (``test_full_horizon_view_frames_byte_identical_to_global``); and a
  6-node port ring of transports, threaded and reactor, one node closed,
  publishes the view-off run's frames byte for byte;
- 6-node groups, ref/port mixed and threaded or reactor, under a small view
  with one node closed: every round's decisions, merges and frames, every
  membership event, the cap evictions and promotions, and the trust,
  estimator and view snapshots equal an all-reference group's;
- a quarantined peer and a collapsed-trust peer are never cap-evicted, as
  in the reference's transport.

Every socket binds port 0 and peers are wired with ``set_peer_port``.
"""

import dataclasses
import hashlib
import json
import socket

import numpy as np
import pytest
import torch

from dpwa_tpu import config as ref_config
from dpwa_tpu.device import reset_device_stats
from dpwa_tpu.health.scoreboard import Scoreboard as RefScoreboard
from dpwa_tpu.membership.manager import MembershipManager as RefManager
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch import config
from dpwa_tpu_torch.health.scoreboard import PeerState, Scoreboard
from dpwa_tpu_torch.membership.manager import MembershipManager
from dpwa_tpu_torch.parallel import tcp

FAST_MEMBER = dict(dead_after_quarantines=2, dead_gossip_rounds=3)
# The transport groups: a fast path to a dead eviction, and deadlines no
# loaded CPU can lapse, so every outcome is the wire's.
GROUP = dict(schedule="ring", interpolation="clock", factor=0.7, timeout_ms=3000, seed=11)
GROUP_HEALTH = {"jitter_rounds": 0, "quarantine_base_rounds": 1, "quarantine_max_rounds": 2}
GROUP_MEMBER = {"dead_after_quarantines": 1, "dead_gossip_rounds": 2}
GROUP_FLOWCTL = {"min_ms": 3000.0, "max_ms": 5000.0, "hedge": False, **{
    "token_rate": 1e9, "token_burst": 1e9}}
N, DOWN, ROUNDS, DIM = 6, 4, 26, 96


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


def test_full_horizon_view_frames_byte_identical_to_global():
    """Mirrors the test of that name on the port's managers (and holds the
    frames to the reference's too): node 5 is down for rounds 3..13, goes
    dead and is evicted, then serves again unnoticed (evicted peers leave
    the digests, so no refutation reaches it)."""
    n = 16
    full = dict(enabled=True, active_size=n - 1, passive_size=0, digest_sample=n, state_cap=n,
                shuffle_every=0)

    def drive(view, ref):
        H, M, S, MM = ((ref_config.HealthConfig, ref_config.MembershipConfig, RefScoreboard,
                        RefManager) if ref else
                       (config.HealthConfig, config.MembershipConfig, Scoreboard,
                        MembershipManager))
        boards, mgrs = {}, {}
        for p in range(n):
            boards[p] = S(n, p, H(jitter_rounds=0), seed=0)
            kw = dict(FAST_MEMBER, **({"view": view} if view else {}))
            mgrs[p] = MM(n, p, boards[p], M(**kw), seed=0)
        pairs = [(p, (p + 1) % n) for p in range(0, n, 2)]
        frames_log, events_log, dead = [], [], 5
        for r in range(20):
            frames = {p: m.encode(r) for p, m in mgrs.items() if not (3 <= r < 14 and p == dead)}
            frames_log.append(frames)
            for a, b in pairs:
                for x, y in ((a, b), (b, a)):
                    if x in frames and y in frames:
                        mgrs[x].merge(frames[y], r)
            for p, m in mgrs.items():
                if p in frames and p != dead:
                    # The re-admission probes too, so node 5 goes dead.
                    outcome = "success" if dead in frames else "timeout"
                    if boards[p].probe_due(dead, r):
                        boards[p].record_probe(dead, outcome, round=r)
                    else:
                        boards[p].record(dead, outcome, round=r)
                if p in frames:
                    m.end_round(r)
            events_log.append({p: mgrs[p].pop_events() for p in sorted(mgrs)})
        return frames_log, events_log

    frames_g, events_g = drive(None, False)
    frames_v, events_v = drive(full, False)
    assert frames_g == frames_v, "raw frames diverged under full horizon"
    assert events_g == events_v, "plane decisions diverged"
    assert drive(full, True) == (frames_v, events_v)
    seen = {e["event"] for ev in events_g for es in ev.values() for e in es}
    assert "peer_dead" in seen


def _group(kinds, view, rx):
    common = dict(GROUP, rx_server=rx)
    member = dict(GROUP_MEMBER, **({"view": dict(view, enabled=True)} if view else {}))
    ref_cfg = _ephemeral(ref_config.make_local_config(
        len(kinds), base_port=0, health=GROUP_HEALTH, membership=member, flowctl=GROUP_FLOWCTL,
        **common))
    port_cfg = _ephemeral(config.make_local_config(
        len(kinds), health=GROUP_HEALTH, membership=member, flowctl=GROUP_FLOWCTL, **common))
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


def _sha(frame):
    return hashlib.sha256(frame).hexdigest()


def _group_run(kinds, view, rx="threaded"):
    """Lock-step rounds of a 6-node ring (every live node publishes, then
    every live node exchanges); node 5 closes at round DOWN.  Every round's
    decisions, α, merged replica and the SHA-256 of each frame served, and
    at the end each survivor's events and snapshots."""
    reset_device_stats()
    nodes = _group(kinds, view, rx)
    rng = np.random.default_rng(0)
    vecs = [rng.standard_normal(DIM).astype(np.float32) for _ in kinds]
    log, events = [], [[] for _ in kinds]
    try:
        for r in range(ROUNDS):
            if r == DOWN:
                nodes[5].close()
            live = [i for i in range(N) if r < DOWN or i != 5]
            for i in live:
                v = vecs[i] if kinds[i] == "ref" else torch.from_numpy(vecs[i])
                nodes[i].publish(v, r + 1.0 + i, 0.5)
            for i in live:
                v = vecs[i] if kinds[i] == "ref" else torch.from_numpy(vecs[i])
                merged, alpha, _ = nodes[i].exchange(v, r + 1.0 + i, 0.5, r)
                vecs[i] = np.asarray(merged, np.float32).copy()
                lr = nodes[i].last_round
                log.append((r, i, lr["sched_partner"], lr["partner"], lr["remapped"],
                            lr["outcome"], float(alpha), _sha(nodes[i].server._payload),
                            vecs[i].view(np.int32).tobytes()))
                events[i].extend(nodes[i].pop_membership_events())
        snaps = []
        for i in range(N - 1):
            t = nodes[i]
            snap = json.loads(json.dumps(t.health_snapshot(), sort_keys=True, default=str))
            est = {p: {k: v for k, v in info.items() if k in ("samples", "hedges", "busy", "slow")}
                   for p, info in snap["flowctl"]["peers"].items()}
            snaps.append({"membership": snap.get("membership"), "trust": snap["trust"]["peers"],
                          "estimator": est, "view": (snap.get("wire") or {}).get("view"),
                          "evicted": snap.get("evicted"),
                          "states": {p: info["state"] for p, info in snap["peers"].items()
                                     if "state" in info}})
    finally:
        for t in nodes:
            t.close()
    return log, json.loads(json.dumps(events)), snaps


@pytest.mark.parametrize("rx", ["threaded", "reactor"])
def test_identity_view_ring_publishes_the_view_off_frames(rx):
    """The identity guarantee on the wire: a port ring with the view at
    ``digest_sample = state_cap = N`` and ``active_size = N - 1`` makes
    the view-off ring's decisions and merges and serves its frames, SHA-256
    for SHA-256, across node 5's close, quarantine and dead eviction."""
    identity = dict(active_size=N - 1, passive_size=0, digest_sample=N, state_cap=N,
                    shuffle_every=0)
    want, want_events, _ = _group_run(("port",) * N, None, rx)
    got, got_events, snaps = _group_run(("port",) * N, identity, rx)
    assert got == want
    assert got_events == want_events
    assert any(e["event"] == "peer_dead" for ev in want_events for e in ev)
    assert all(s["view"]["view_evicted_dead"] == 1 for s in snaps)


SMALL_VIEW = dict(active_size=2, passive_size=2, digest_sample=2, state_cap=3, shuffle_every=2)


@pytest.mark.parametrize("kinds,rx", [
    (("ref", "port", "port", "ref", "port", "ref"), "threaded"),
    (("port", "ref", "ref", "port", "ref", "port"), "reactor"),
])
def test_mixed_group_with_a_small_view_equals_all_reference(kinds, rx):
    """A ref/port group under ``active 2, passive 2, digest_sample 2,
    state_cap 3``, node 5 closed at round 4: every round's decisions,
    merges and frame SHA-256s, every membership event (cap evictions and
    promotions among them) and the view, trust, estimator and scoreboard
    snapshots equal an all-reference group's."""
    want_log, want_events, want_snaps = _group_run(("ref",) * N, SMALL_VIEW, rx)
    got_log, got_events, got_snaps = _group_run(kinds, SMALL_VIEW, rx)
    for got, want in zip(got_log, want_log):
        assert got[:7] == want[:7], (got[:7], want[:7])
        assert got == want, got[:2]  # the frame and the merged replica
    assert len(got_log) == len(want_log)
    assert got_events == want_events
    assert got_snaps == want_snaps
    # The scenario did what it should: caps, a dead eviction and digests of
    # at most digest_sample + 1 entries.
    views = [s["view"] for s in want_snaps]
    assert sum(v["view_evicted_cap"] for v in views) > 0
    assert sum(v["view_evicted_dead"] for v in views) > 0
    assert sum(v["view_promotions"] for v in views) > 0
    assert all(v["view_digest_entries"] <= SMALL_VIEW["digest_sample"] + 1 for v in views)
    assert any(e["event"] == "peers_capped" for ev in want_events for e in ev)


@pytest.mark.parametrize("kind", ["quarantined", "collapsed"])
def test_protected_peers_are_never_cap_evicted(kind):
    """Mirrors ``test_quarantined_peer_is_never_cap_evicted`` and
    ``test_collapsed_trust_protects_peer_from_cap`` through each package's
    transport wiring (its trust plane registered as a cap protector): a
    full-universe digest overflows ``state_cap`` 4, and peer 9 stays."""
    n = 16
    view = dict(enabled=True, active_size=2, passive_size=4, digest_sample=16, state_cap=4)
    out = []
    for ref in (False, True):
        if ref:
            cfg = _ephemeral(ref_config.make_local_config(n, base_port=0, membership={"view": view},
                                                          health={"jitter_rounds": 0}))
            t = ref_tcp.TcpTransport(cfg, "node0")
            g_board = RefScoreboard(n, 1, ref_config.HealthConfig(jitter_rounds=0))
            gossip = RefManager(n, 1, g_board, ref_config.MembershipConfig(**FAST_MEMBER))
        else:
            cfg = _ephemeral(config.make_local_config(n, membership={"view": view},
                                                      health={"jitter_rounds": 0}))
            t = tcp.TcpTransport(cfg, "node0", device="cpu")
            g_board = Scoreboard(n, 1, config.HealthConfig(jitter_rounds=0))
            gossip = MembershipManager(n, 1, g_board, config.MembershipConfig(**FAST_MEMBER))
        try:
            if kind == "quarantined":
                for r in range(1, 6):
                    t.scoreboard.record(9, "timeout", round=r)
                assert t.scoreboard.state(9) == PeerState.QUARANTINED
            else:
                t.trust._collapsed[9] = True
            t.membership.merge(gossip.encode(6), 6)
            t.membership.end_round(6)
            capped = sorted(t.membership._capped)
            out.append((capped, t.membership.view_snapshot()["view"],
                        t.trust.snapshot()["peers"]))
        finally:
            t.close()
    assert out[0] == out[1]
    capped = out[0][0]
    assert capped and 9 not in capped
