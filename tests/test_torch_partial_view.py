"""The port's bounded partial view against the reference's, on the CPU.

Mirrors ``tests/test_partial_view.py``'s unit and manager tests; the
reference's objects run here on the same inputs (its own tests are red in
the driver's parallel runs, so their output is no ground truth):

- ``view_sample_draw`` and ``passive_shuffle_draw`` bit-equal over seeds,
  clocks, peers and candidate counts;
- ``ViewConfig`` accepting and refusing what the reference's does, as a
  YAML mapping inside ``membership:``;
- :class:`PartialView` op for op against the reference's class: the
  bootstrap, touches refilling the active then the passive view, forgets
  promoting a drawn passive peer, the shuffle, ``sample_digest`` with
  damning peers, ``cap_victims``;
- the membership manager fed the same digests and fetch outcomes as a
  reference manager: the encoded digests byte for byte, the events, the
  evictions by cause, the quorum over the tracked horizon, the snapshot's
  ``view`` group;
- trust's capped snapshot and residency against the reference's, and the
  hierarchical topology's island-first bootstrap.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dpwa_tpu import config as ref_config
from dpwa_tpu.flowctl.estimator import DeadlineEstimator as RefEstimator
from dpwa_tpu.health.scoreboard import Scoreboard as RefScoreboard
from dpwa_tpu.membership.manager import MembershipManager as RefManager
from dpwa_tpu.membership.partial_view import PartialView as RefPartialView
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu.trust.manager import TrustManager as RefTrust
from dpwa_tpu_torch import config
from dpwa_tpu_torch.flowctl.estimator import DeadlineEstimator
from dpwa_tpu_torch.health.scoreboard import Scoreboard
from dpwa_tpu_torch.membership.manager import MembershipManager
from dpwa_tpu_torch.membership.partial_view import PartialView
from dpwa_tpu_torch.parallel import schedules
from dpwa_tpu_torch.trust.manager import TrustManager

FAST_MEMBER = dict(dead_after_quarantines=2, dead_gossip_rounds=3)


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_view_draws_bit_equal_to_reference(seed):
    for clock in (0, 1, 9, 4096, 2**31 - 1):
        for me in (0, 5, 15):
            for n in (1, 2, 3, 16, 63):
                got = schedules.view_sample_draw(seed, clock, me, n)
                want = ref_schedules.view_sample_draw(seed, clock, me, n)
                assert np.array_equal(got, want), (clock, me, n)
                assert schedules.passive_shuffle_draw(seed, clock, me, n) == int(
                    ref_schedules.passive_shuffle_draw(seed, clock, me, n)), (clock, me, n)


@pytest.mark.parametrize("case", ["absent", "on", "cap_below_active", "bad_values", "unknown"])
def test_view_config_loads_and_refuses_as_reference(case):
    views = {
        "absent": [None], "on": [{"enabled": True, "digest_sample": 5, "state_cap": 9}],
        "cap_below_active": [{"state_cap": 2, "active_size": 4}],
        "bad_values": [{"active_size": 0}, {"digest_sample": 0}, {"passive_size": -1},
                       {"state_cap": 0}, {"shuffle_every": -1}],
        "unknown": [{"enabled": True, "bogus": 1}],
    }[case]
    for view in views:
        doc = {"nodes": ["a", "b"], "membership": {} if view is None else {"view": view}}
        try:
            want = ref_config.config_from_dict(doc).membership.view
        except (TypeError, ValueError) as exc:
            with pytest.raises(type(exc)) as got:
                config.config_from_dict(doc)
            assert str(got.value) == str(exc) or isinstance(exc, TypeError), view
            continue
        assert case in ("absent", "on")
        got = config.config_from_dict(doc).membership.view
        assert isinstance(got, config.ViewConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        built = config.make_local_config(2, membership={"view": dict(view or {})}).membership.view
        assert dataclasses.asdict(built) == dataclasses.asdict(want)


def _state(pv):
    return (sorted(pv.active), sorted(pv.passive), dict(sorted(pv._last_touch.items())),
            pv.promotions, pv.shuffles, pv.snapshot())


def _views(n, me, seed, **kw):
    kw.setdefault("enabled", True)
    return (PartialView(n, me, config.ViewConfig(**kw), seed=seed),
            RefPartialView(n, me, ref_config.ViewConfig(**kw), seed=seed))


@pytest.mark.parametrize("scenario", ["bootstrap", "touch_forget", "shuffle", "sample_and_cap"])
def test_partial_view_units_equal_to_reference(scenario):
    """Scripted operations from a seeded stream, applied to a port and a
    reference view alike; their states (views, recency, counters, the
    snapshot) and results equal after every one."""
    rng = np.random.default_rng(["bootstrap", "touch_forget", "shuffle",
                                 "sample_and_cap"].index(scenario))
    if scenario == "bootstrap":
        for n, me, a, p in ((16, 3, 4, 6), (5, 4, 8, 32), (64, 63, 8, 32), (2, 0, 1, 0)):
            mine, ref = _views(n, me, 0, active_size=a, passive_size=p)
            assert _state(mine) == _state(ref)
        mine, _ = _views(16, 3, 0, active_size=4, passive_size=6)
        assert (sorted(mine.active), sorted(mine.passive)) == ([4, 5, 6, 7], list(range(8, 14)))
        return
    for seed in range(3):
        n = 48
        mine, ref = _views(n, seed, seed, active_size=3, passive_size=4, shuffle_every=4,
                           digest_sample=5)
        # Each scenario's operations, drawn uniformly each step.
        ops = {"touch_forget": "ttf", "shuffle": "tttsf", "sample_and_cap": "tfc"}[scenario]
        for step in range(120):
            op = ops[int(rng.integers(0, len(ops)))]
            peer = int(rng.integers(-1, n + 1))
            r = step if scenario == "shuffle" else int(rng.integers(0, 40))
            if op == "t":
                mine.touch(peer, r)
                ref.touch(peer, r)
            elif op == "f":
                victim = int(rng.choice(sorted(mine.active | mine.passive | {peer % n})))
                mine.forget(victim)
                ref.forget(victim)
            elif op == "s":
                mine.maybe_shuffle(r)
                ref.maybe_shuffle(r)
            else:
                size = int(rng.choice([0, 4, 6, 12, 19]))  # a few sizes: each compiles once
                cands = sorted(rng.choice(n, size, replace=False).tolist())
                damning = set(rng.choice(n, int(rng.integers(0, 8)), replace=False).tolist())
                assert mine.sample_digest(cands, damning, r) == ref.sample_digest(cands, damning, r)
                resident = rng.choice(n, int(rng.integers(0, 30)), replace=False).tolist()
                protected = rng.choice(n, 3, replace=False).tolist()
                excess = int(rng.integers(-1, 10))
                assert mine.cap_victims(resident, protected, excess) == ref.cap_victims(
                    resident, protected, excess)
            assert _state(mine) == _state(ref), (seed, step)
            assert mine.last_touch(peer) == ref.last_touch(peer)
        if scenario == "touch_forget":
            assert mine.promotions > 0
        if scenario == "shuffle":
            assert mine.shuffles > 0


VIEWS = {
    "tight": dict(active_size=4, passive_size=4, digest_sample=4, state_cap=8, shuffle_every=4),
    "wide": dict(active_size=6, passive_size=10, digest_sample=9, state_cap=14, shuffle_every=3),
    "identity": dict(active_size=23, passive_size=0, digest_sample=24, state_cap=24,
                     shuffle_every=0),
}


def _drive(kind, n, view, rounds=30, dead=5, down=(3, 20)):
    """``n`` managers of one package gossiping on rotating partners with their
    own scoreboards; ``dead`` serves nothing over ``down`` and its
    neighbours record timeouts then successes.  Each round: every frame,
    every node's events and ``view_snapshot``, and the scoreboards'
    tombstones."""
    if kind == "ref":
        H, M, S, MM = ref_config.HealthConfig, ref_config.MembershipConfig, RefScoreboard, RefManager
    else:
        H, M, S, MM = config.HealthConfig, config.MembershipConfig, Scoreboard, MembershipManager
    boards, mgrs = {}, {}
    for p in range(n):
        boards[p] = S(n, p, H(jitter_rounds=0), seed=3)
        mgrs[p] = MM(n, p, boards[p], M(**FAST_MEMBER, view=dict(view, enabled=True)), seed=3)
    log = []
    for r in range(rounds):
        frames = {p: m.encode(r) for p, m in mgrs.items()
                  if not (down[0] <= r < down[1] and p == dead)}
        for p in range(n):
            q = (p + 1 + 5 * r % (n - 1)) % n  # a partner further round each round
            if p in frames and q in frames:
                mgrs[p].merge(frames[q], r)
        for p, m in mgrs.items():
            if p in frames:
                outcome = "success" if dead in frames else "timeout"
                if p != dead and boards[p].probe_due(dead, r):
                    boards[p].record_probe(dead, outcome, round=r)
                elif dead in frames or p != dead and (p + r) % 2 == 0:
                    boards[p].record(dead, outcome, round=r)
                m.end_round(r)
        log.append((frames, {p: m.pop_events() for p, m in mgrs.items()},
                    {p: m.view_snapshot() for p, m in mgrs.items()},
                    {p: b.evicted_peers() for p, b in boards.items()},
                    {p: (m.partner_candidates(), m.degraded) for p, m in mgrs.items()}))
    return log, mgrs


@pytest.mark.parametrize("view", list(VIEWS))
def test_manager_under_a_view_equals_reference(view):
    """Mirrors ``test_digest_sampling_bounds_frame_entries``,
    ``test_state_cap_evicts_through_listener_path_and_retracks`` and
    ``test_quorum_runs_over_tracked_horizon_not_n_peers``: 24 managers per
    package, a node down for 17 rounds; every digest byte for byte, every
    event, snapshot, tombstone, active view and degraded flag equal."""
    n = 24
    want, ref_mgrs = _drive("ref", n, VIEWS[view])
    got, mgrs = _drive("port", n, VIEWS[view])
    for r, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], ("frames", r)
        assert g[1:] == w[1:], r
    cfg = VIEWS[view]
    for m in mgrs.values():
        assert m._digest_entries_last <= cfg["digest_sample"] + 1
        assert m._peak_resident <= cfg["state_cap"]
        assert not m.degraded  # quorum over the tracked horizon, not N
    causes = [m._evictions_by_cause for m in mgrs.values()]
    assert causes == [m._evictions_by_cause for m in ref_mgrs.values()]
    assert sum(c["dead"] for c in causes) > 0
    if view != "identity":
        assert sum(c["cap"] for c in causes) > 0
        assert sum(m.partial.promotions for m in mgrs.values()) > 0


def test_manager_retracks_a_capped_peer_as_reference():
    """Mirrors ``test_state_cap_evicts_through_listener_path_and_retracks``:
    a full-universe digest overflows the cap; the victims go through the
    evict listeners and carry a scoreboard tombstone; a later mention and a
    probe of a capped peer re-track it, as in the reference."""
    n = 32
    view = dict(enabled=True, active_size=4, passive_size=8, digest_sample=16, state_cap=8)
    out = []
    for H, M, S, MM in ((config.HealthConfig, config.MembershipConfig, Scoreboard,
                         MembershipManager),
                        (ref_config.HealthConfig, ref_config.MembershipConfig, RefScoreboard,
                         RefManager)):
        board = S(n, 0, H(jitter_rounds=0), seed=0)
        mgr = MM(n, 0, board, M(**FAST_MEMBER, view=view), seed=0)
        dropped = []
        mgr.add_evict_listener(dropped.append)
        gboard = S(n, 1, H(jitter_rounds=0), seed=0)
        gmgr = MM(n, 1, gboard, M(**FAST_MEMBER), seed=0)
        mgr.merge(gmgr.encode(0), 0)
        mgr.end_round(0)
        capped, tombstones = sorted(mgr._capped), board.evicted_peers()
        snap = mgr.view_snapshot()
        # A probe of one capped peer, then a digest naming them all.
        mgr.on_peer_returned(dropped[1], round=1)
        after_probe = sorted(mgr._capped)
        mgr.merge(gmgr.encode(1), 1)
        out.append((dropped, capped, tombstones, snap, after_probe, sorted(mgr._capped),
                    board.evicted_peers(), mgr.encode(2), mgr.view_snapshot(), mgr.pop_events()))
    assert out[0] == out[1]
    dropped, capped, tombstones, snap, after_probe, after, after_tombstones = out[0][:7]
    assert dropped and sorted(dropped) == capped == tombstones
    assert snap["view"]["view_capped"] == len(capped) and snap["view"]["view_tracked"] <= 8
    # The digest's mention clears the tombstones of the peers it re-tracks;
    # the probed one was re-tracked by the probe, whose scoreboard path (not
    # called here) clears its own.
    assert dropped[1] not in after_probe and after == [] and after_tombstones == [dropped[1]]


def test_capped_trust_and_estimator_snapshots_equal_reference():
    """Mirrors ``test_trust_and_estimator_capped_snapshots_iterate_tracked_only``
    and ``test_collapsed_trust_protects_peer_from_cap``: with capped
    snapshots trust lists the tracked peers only; residency and the
    collapse verdict read as the reference's."""
    mine, ref = TrustManager(256, 0), RefTrust(256, 0)
    for t in (mine, ref):
        t.enable_capped_snapshots()
    local = np.zeros(8, np.float32)
    for peer in (3, 200):
        mine.screen(peer, torch.ones(8), 1.0, torch.from_numpy(local), round=1)
        ref.screen(peer, np.ones(8, np.float32), 1.0, local, round=1)
    assert mine.snapshot() == ref.snapshot()
    assert sorted(mine.snapshot()["peers"]) == [3, 200]
    assert mine.tracked_peers() == ref.tracked_peers() == [3, 200]
    mine._collapsed[9] = ref._collapsed[9] = True
    assert [mine.is_collapsed(p) for p in (3, 9)] == [ref.is_collapsed(p) for p in (3, 9)]
    assert DeadlineEstimator(timeout_ms=100.0).tracked_peers() == RefEstimator(
        timeout_ms=100.0).tracked_peers() == []
    # Uncapped, every peer is listed, as before.
    assert len(TrustManager(16, 0).snapshot()["peers"]) == 15


def test_topology_is_refused_naming_the_hierarchical_item():
    """The hierarchical bootstrap, once refused, is accepted: the island's
    members, the other leaders, then the ring successors, as the
    reference's."""
    from dpwa_tpu.hier import LeaderBoard as RefLeaderBoard
    from dpwa_tpu.hier import Topology as RefTopology
    from dpwa_tpu_torch.hier import LeaderBoard, Topology

    topo, ref_topo = Topology.uniform(4, 4), RefTopology.uniform(4, 4)
    mine = PartialView(16, 0, config.ViewConfig(enabled=True), topology=topo,
                       leader_board=LeaderBoard(topo))
    ref = RefPartialView(16, 0, ref_config.ViewConfig(enabled=True), topology=ref_topo,
                         leader_board=RefLeaderBoard(ref_topo))
    assert mine._initial_candidates() == ref._initial_candidates()
    assert mine._initial_candidates()[:3] == [1, 2, 3]
    assert (sorted(mine.active), sorted(mine.passive)) == (sorted(ref.active), sorted(ref.passive))
