"""Hierarchical gossip in the port against the reference, on the CPU: the
``topology:`` block and its validation, ``leader_draw`` /
``island_churn_draw``, :class:`Topology`, the :class:`LeaderBoard`'s
elections and events, the hier pool, the v2 digest and its adoption, the
island-first partial view, the incident plane's island classes and the
:class:`HierGossipEngine` (replicas bit for bit, frames and records
exactly, the convergence history within 1e-12: it is reduced in a
different order), with bench.py's island sweep reproduced."""

import dataclasses
import os

import numpy as np
import pytest

import bench
from dpwa_tpu import config as ref_config
from dpwa_tpu import hier as ref_hier
from dpwa_tpu.health.scoreboard import Scoreboard as RefScoreboard
from dpwa_tpu.membership.manager import MembershipManager as RefManager
from dpwa_tpu.membership.partial_view import PartialView as RefPartialView
from dpwa_tpu.obs import incidents as ref_incidents
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu_torch import config, hier
from dpwa_tpu_torch.health.scoreboard import Scoreboard
from dpwa_tpu_torch.membership.digest import DIGEST_VERSION_HIER, decode_digest
from dpwa_tpu_torch.membership.manager import MembershipManager
from dpwa_tpu_torch.membership.partial_view import PartialView
from dpwa_tpu_torch.obs import incidents
from dpwa_tpu_torch.parallel import schedules

TWO_PODS = {"islands": [{"name": "pod-a", "nodes": [f"node{i}" for i in range(4)]},
                        {"name": "pod-b", "nodes": [f"node{i}" for i in range(4, 8)]}]}


def _islands(n_islands, size, **kw):
    return {"islands": [{"name": f"isl{g}", "nodes": [f"node{g * size + i}" for i in range(size)]}
                        for g in range(n_islands)], **kw}


def _pair(n, **kw):
    """The port's and the reference's local config of ``n`` peers."""
    return config.make_local_config(n, **kw), ref_config.make_local_config(n, base_port=0, **kw)


def test_topology_block_loads_like_the_reference(tmp_path):
    """Mappings, the bare-list shorthand, ``leader_seed`` and
    ``intra_rounds`` load to the reference's fields, from a dict, from a
    YAML file and through ``make_local_config``; an absent block is flat."""
    raw = {"nodes": [f"n{i}" for i in range(6)],
           "topology": {"islands": [{"name": "a", "nodes": ["n0", "n1", "n2"]}, ["n3", "n4", "n5"]],
                        "leader_seed": 5, "intra_rounds": 2}}
    mine, ref = config.config_from_dict(raw), ref_config.config_from_dict(raw)
    assert dataclasses.asdict(mine.topology) == dataclasses.asdict(ref.topology)
    assert mine.topology.enabled and [i.name for i in mine.topology.islands] == ["a", "island1"]
    path = tmp_path / "nodes.yaml"
    path.write_text("nodes: [n0, n1, n2, n3, n4, n5]\ntopology:\n  islands:\n"
                    "    - {name: a, nodes: [n0, n1, n2]}\n    - [n3, n4, n5]\n"
                    "  leader_seed: 5\n  intra_rounds: 2\n")
    assert config.load_config(str(path)).topology == mine.topology
    port, ref = _pair(8, topology=TWO_PODS)
    assert dataclasses.asdict(port.topology) == dataclasses.asdict(ref.topology)
    assert not config.make_local_config(4).topology.enabled
    assert config.make_local_config(4).topology == config.TopologyConfig()
    for block in ("run", "tune"):
        with pytest.raises(NotImplementedError, match=repr(block)):
            config.config_from_dict({"nodes": ["a"], block: {}})


def test_validation_messages_equal_the_reference():
    """Every ``ValueError`` of the block, word for word: an unknown node, a
    node in two islands, an uncovered node, an empty island, duplicate
    island names, a node listed twice, ``intra_rounds < 1``."""
    cases = [
        [{"name": "a", "nodes": ["node0", "ghost"]}, {"name": "b", "nodes": ["node1", "node2", "node3"]}],
        [{"name": "a", "nodes": ["node0", "node1"]}, {"name": "b", "nodes": ["node1", "node2", "node3"]}],
        [{"name": "a", "nodes": ["node0", "node1", "node2"]}],
        [{"name": "a", "nodes": []}, {"name": "b", "nodes": ["node0", "node1", "node2", "node3"]}],
        [{"name": "a", "nodes": ["node0", "node1"]}, {"name": "a", "nodes": ["node2", "node3"]}],
        [{"name": "a", "nodes": ["node0", "node0", "node1"]}, ["node2", "node3"]],
    ]
    messages = []
    for islands in [*({"islands": c} for c in cases), {"intra_rounds": 0}]:
        got = []
        for make in (config.make_local_config,
                     lambda n, **kw: ref_config.make_local_config(n, base_port=0, **kw)):
            with pytest.raises(ValueError) as err:
                make(4, topology=islands)
            got.append(str(err.value))
        assert got[0] == got[1]
        messages.append(got[0])
    assert "'ghost'" in messages[0] and "both island 'a' and island 'b'" in messages[1]
    assert "['node3']" in messages[2] and "lists no nodes" in messages[3]
    assert "duplicate island names" in messages[4] and "more than once" in messages[5]
    assert "intra_rounds" in messages[6]


def test_leader_and_island_churn_draws_are_the_references():
    for seed in (0, 1, 7, 2**31 - 1):
        for term in (0, 1, 3, 100):
            for island in (0, 1, 5):
                for n in (1, 2, 4, 16):
                    assert schedules.leader_draw(seed, term, island, n) == ref_schedules.leader_draw(
                        seed, term, island, n)
                assert schedules.island_churn_draw(seed, term, island) == \
                    ref_schedules.island_churn_draw(seed, term, island)


def test_topology_resolves_like_the_reference():
    port, ref = _pair(8, topology=TWO_PODS)
    mine, theirs = hier.Topology.from_config(port), ref_hier.Topology.from_config(ref)
    assert (mine.names, mine.members, mine.n_peers) == (theirs.names, theirs.members, theirs.n_peers)
    assert [mine.island_of(p) for p in range(8)] == [theirs.island_of(p) for p in range(8)]
    assert mine.members_of(1) == (4, 5, 6, 7) and mine.island_name(1) == "pod-b"
    uni, ref_uni = hier.Topology.uniform(4, 3), ref_hier.Topology.uniform(4, 3)
    assert (uni.names, uni.members, uni.n_islands) == (ref_uni.names, ref_uni.members, 4)
    for bad in (dict(names=("a", "b"), members=((0, 1), (1, 2)), n_peers=3),
                dict(names=("a",), members=((0, 2),), n_peers=3)):
        with pytest.raises(ValueError) as mine_err:
            hier.Topology(**bad)
        with pytest.raises(ValueError) as ref_err:
            ref_hier.Topology(**bad)
        assert str(mine_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="flat config"):
        hier.Topology.from_config(config.make_local_config(4))


def test_leader_board_scripted_sequence_equals_the_reference():
    """Deaths of leaders and followers, a leaderless island, a returnee, and
    stale, same-term and fresher adoptions: the same leaders, terms and
    events after every call."""
    for shape, seed in (((2, 4), 0), ((4, 4), 3), ((3, 5), 11)):
        boards = [cls(topo_cls.uniform(*shape), seed=seed)
                  for cls, topo_cls in ((hier.LeaderBoard, hier.Topology),
                                        (ref_hier.LeaderBoard, ref_hier.Topology))]
        assert boards[0].initial_events() == boards[1].initial_events()
        script = [("note_dead", (boards[1].leader_of(0),)), ("note_dead", (0,)), ("note_dead", (1,)),
                  ("note_alive", (0,)), ("adopt", (1, 0, 5)), ("adopt", (1, 4, None)),
                  ("adopt", (1, 2, 4)), ("adopt", (0, 9, 2))]
        script += [("note_dead", (p,)) for p in range(shape[1])]
        script += [("note_alive", (shape[1] - 1,)), ("note_alive", (0,))]
        for name, args in script:
            got, want = (getattr(b, name)(*args) for b in boards)
            assert got == want, (shape, name, args)
            assert boards[0].leaders() == boards[1].leaders()
            assert [boards[0].term_of(g) for g in range(shape[0])] == [
                boards[1].term_of(g) for g in range(shape[0])]
            assert [boards[0].is_leader(p) for p in range(shape[0] * shape[1])] == [
                boards[1].is_leader(p) for p in range(shape[0] * shape[1])]


@pytest.mark.parametrize("shape,kw", [((2, 4), {}), ((4, 4), {"leader_seed": 3}),
                                      ((2, 4), {"intra_rounds": 2})])
def test_hier_pool_and_branch_map_equal_the_reference(shape, kw):
    port, ref = _pair(shape[0] * shape[1], topology=_islands(*shape, **kw), seed=4,
                      fetch_probability=0.5)
    mine, theirs = hier.build_hier_schedule(port), ref_hier.build_hier_schedule(ref)
    assert mine.name == theirs.name == "hier"
    np.testing.assert_array_equal(mine.pool, theirs.pool)
    np.testing.assert_array_equal(mine.branch_map, theirs.branch_map)
    assert mine.pool.dtype == theirs.pool.dtype and mine.branch_map.dtype == theirs.branch_map.dtype
    assert (mine.seed, mine.fetch_probability, mine.mode) == (theirs.seed, theirs.fetch_probability,
                                                              theirs.mode)
    topo = hier.Topology.from_config(port)
    wide = hier.wide_slot_indices(mine, topo)
    assert wide == ref_hier.wide_slot_indices(theirs, ref_hier.Topology.from_config(ref))
    for step in range(2 * mine.period):
        assert [mine.participates(step, i) for i in range(mine.n_peers)] == [
            theirs.participates(step, i) for i in range(theirs.n_peers)]
    if shape == (2, 4) and not kw:
        assert mine.pool.tolist() == [[1, 0, 3, 2, 5, 4, 7, 6], [3, 2, 1, 0, 7, 6, 5, 4],
                                      [0, 1, 2, 4, 3, 5, 6, 7]]
        assert mine.branch_map.tolist() == [0, 1, 2] and wide == (2,)


def _managers(n, me, topo_shape, view=None):
    member = {"view": dict(view, enabled=True)} if view else {}
    return (MembershipManager(n, me, Scoreboard(n, me), config.MembershipConfig(**member),
                              topology=hier.Topology.uniform(*topo_shape)),
            RefManager(n, me, RefScoreboard(n, me), ref_config.MembershipConfig(**member),
                       topology=ref_hier.Topology.uniform(*topo_shape)))


def test_manager_v2_digests_and_adoption_equal_the_reference():
    """v2 digest bytes from managers of each package, a succession adopted
    off a fresher claim (and a stale and a mismatched-island claim
    ignored), with the same boards, events and next digests."""
    mine0, ref0 = _managers(8, 0, (2, 4))
    mine1, ref1 = _managers(8, 1, (2, 4))
    assert mine0.encode(1) == ref0.encode(1)
    assert decode_digest(mine0.encode(1)).version == DIGEST_VERSION_HIER
    for m in (mine1, ref1):
        m.leader_board.note_dead(m.leader_board.leader_of(0))
        m.scoreboard.record(5, "timeout", round=2)
    blob = ref1.encode(2)
    assert mine1.encode(2) == blob
    mine0.merge(blob, round=2)
    ref0.merge(blob, round=2)
    assert mine0.leader_board.leaders() == ref0.leader_board.leaders()
    assert mine0.leader_board.term_of(0) == 1
    assert mine0.pop_events() == ref0.pop_events()
    for m in (mine0, ref0):  # a stale claim, then the same claim again
        m.merge(ref1.encode(3), round=3)
    assert mine0.pop_events() == ref0.pop_events() == []
    assert mine0.encode(4) == ref0.encode(4)
    assert mine0.view_snapshot() == ref0.view_snapshot()


@pytest.mark.parametrize("me", [0, 5])
def test_hier_partial_view_bootstraps_island_first_like_the_reference(me):
    view = config.ViewConfig(enabled=True, active_size=4, passive_size=4)
    ref_view = ref_config.ViewConfig(enabled=True, active_size=4, passive_size=4)
    topo, ref_topo = hier.Topology.uniform(4, 3), ref_hier.Topology.uniform(4, 3)
    board, ref_board = hier.LeaderBoard(topo, seed=2), ref_hier.LeaderBoard(ref_topo, seed=2)
    mine = PartialView(12, me, view, seed=1, topology=topo, leader_board=board)
    ref = RefPartialView(12, me, ref_view, seed=1, topology=ref_topo, leader_board=ref_board)
    assert mine._initial_candidates() == ref._initial_candidates()
    island = [p for p in topo.members_of(topo.island_of(me)) if p != me]
    assert mine._initial_candidates()[:len(island)] == island
    assert (sorted(mine.active), sorted(mine.passive)) == (sorted(ref.active), sorted(ref.passive))
    bare = PartialView(12, me, view, seed=1, topology=topo)  # no board: island, then successors
    assert bare._initial_candidates() == RefPartialView(
        12, me, ref_view, seed=1, topology=ref_topo)._initial_candidates()
    managers = _managers(12, me, (4, 3), view=dict(active_size=4, passive_size=4))
    assert sorted(managers[0].partial.active) == sorted(managers[1].partial.active)
    assert managers[0].encode(1) == managers[1].encode(1)


ISLAND_FEEDS = {
    # node 0's island is {0..3}: a cut of island 1 exactly, of island 1 and
    # half of island 2 (a straddle), and a leader succession.
    "island_aligned": [(5, dict(events=[{"event": "partition_entered", "component": [0, 1, 2, 3, 8, 9, 10, 11],
                                         "quorum_fraction": 0.67}],
                                partition_state="degraded", component=[0, 1, 2, 3, 8, 9, 10, 11])),
                       (6, dict(partition_state="degraded", component=[0, 1, 2, 3, 8, 9, 10, 11]))],
    "straddling": [(5, dict(events=[{"event": "partition_entered",
                                     "component": [0, 1, 2, 3, 10, 11], "quorum_fraction": 0.5}],
                            partition_state="degraded", component=[0, 1, 2, 3, 10, 11]))],
    "leader_failover": [(3, dict(events=[{"event": "leader_failover", "island": "island1",
                                          "old_leader": 6, "peer": 5, "term": 1}])),
                        *[(s, {}) for s in range(4, 8)]],
}


def test_incident_plane_island_classes_equal_the_reference():
    """The same synthesized event streams through both planes given a 3×4
    topology: an island-aligned cut fires ``island_partition``, a
    straddling one ``partition``, a succession ``leader_failover`` naming
    the old leader with the term as its value; results, records and
    snapshots equal."""
    fired = {}
    for name, feed in ISLAND_FEEDS.items():
        mine = incidents.IncidentPlane(0, 12, config.ObsConfig(incidents=True),
                                       topology=hier.Topology.uniform(3, 4))
        ref = ref_incidents.IncidentPlane(0, 12, ref_config.ObsConfig(incidents=True),
                                          topology=ref_hier.Topology.uniform(3, 4))
        fired[name] = []
        for step, kw in feed:
            got = mine.observe_round(step, **kw)
            assert got == ref.observe_round(step, **kw), (name, step)
            fired[name] += got["alerts"]
            recs = [{k: v for k, v in r.items() if k != "t"} for r in mine.pop_records()]
            assert recs == [{k: v for k, v in r.items() if k != "t"} for r in ref.pop_records()]
            snaps = [p.snapshot() for p in (mine, ref)]
            for s in snaps:
                s["recent_alerts"] = [{k: v for k, v in a.items() if k != "t"}
                                      for a in s["recent_alerts"]]
            assert snaps[0] == snaps[1], (name, step)
        if name == "leader_failover":
            alert = snaps[0]["recent_alerts"][0]
            assert alert["peer"] == 6 and alert["value"] == 1.0
    assert fired == {"island_aligned": ["island_partition"], "straddling": ["partition"],
                     "leader_failover": ["leader_failover"]}


@pytest.mark.parametrize("shape", [None, (2, 4)])
def test_engine_equals_the_reference(shape):
    """Flat and 2×4 at d 32 for 40 rounds: replicas bit for bit, frames,
    records and rounds to target exactly, the history within 1e-12."""
    topo = hier.Topology.uniform(*shape) if shape else None
    ref_topo = ref_hier.Topology.uniform(*shape) if shape else None
    mine = hier.HierGossipEngine(8, dim=32, seed=0, topology=topo, device="cpu")
    ref = ref_hier.HierGossipEngine(8, dim=32, seed=0, topology=ref_topo)
    got, want = mine.run(40, target_rel=0.05), ref.run(40, target_rel=0.05)
    np.testing.assert_array_equal(mine.replicas.numpy(), ref.replicas)
    # rel_rms is reduced in torch's order: within 1e-12, relative or absolute
    # (the spread of converged replicas is rounding noise near 1e-16).
    np.testing.assert_allclose(got.pop("history"), want.pop("history"), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.pop("final_rel_rms"), want.pop("final_rel_rms"), rtol=1e-12,
                               atol=1e-12)
    assert got == want
    assert mine.records == ref.records and mine.events_seen == ref.events_seen
    assert got["rounds_to_target"] == (1 if shape else 12)


def test_leader_kill_opens_one_leader_failover_incident():
    """``tests/test_hier.py``'s episode: island 1's leader killed after
    round 3 gives one succession, one ``leader_failover`` incident, and
    the reference's replicas, events and records."""
    engines = []
    for eng_cls, topo_cls, obs in ((hier.HierGossipEngine, hier.Topology, config.ObsConfig),
                                   (ref_hier.HierGossipEngine, ref_hier.Topology, ref_config.ObsConfig)):
        kw = {"device": "cpu"} if eng_cls is hier.HierGossipEngine else {}
        eng = eng_cls(8, seed=0, topology=topo_cls.uniform(2, 4), incidents=obs(incidents=True), **kw)
        for r in range(3):
            eng.step(r)
        eng.kill(eng.board.leader_of(1))
        for r in range(3, 10):
            eng.step(r)
        engines.append(eng)
    mine, ref = engines
    assert mine.board.term_of(1) == 1 and mine.board.leaders() == ref.board.leaders()
    assert mine.incidents_opened == 1 and mine.alerts_total == {"leader_failover": 1}
    assert ref.incidents_opened == 1 and ref.alerts_total == mine.alerts_total
    assert mine.events_seen == ref.events_seen and mine.records == ref.records
    np.testing.assert_array_equal(mine.replicas.numpy(), ref.replicas)


def test_bench_hier_sweep_is_reproduced_by_the_port():
    """bench.py's ``--hier-leg`` sweep (64 peers, islands of 4, 8 and 16,
    64 rounds, target 0.05) at d 32 with the port's engine: the frames,
    multipliers and rounds to target of ``bench.bench_hier``."""
    want = bench.bench_hier(64, [4, 8, 16], 64, 0.05)
    flat = hier.HierGossipEngine(64, seed=0, device="cpu").run(64, target_rel=0.05)
    assert flat["wide_frames"] == want["flat"]["wide_frames"] == 4096
    assert flat["rounds_to_target"] == want["flat"]["rounds_to_target"] is None
    got = {}
    for size in (4, 8, 16):
        res = hier.HierGossipEngine(64, seed=0, topology=hier.Topology.uniform(64 // size, size),
                                    device="cpu").run(64, target_rel=0.05)
        got[f"{64 // size}x{size}"] = (res["wide_frames"], res["intra_frames"],
                                      round(flat["wide_frames"] / res["wide_frames"], 3),
                                      res["rounds_to_target"])
    assert got == {name: (leg["wide_frames"], leg["intra_frames"], leg["wide_multiplier"],
                          leg["rounds_to_target"]) for name, leg in want["legs"].items()}
    assert [v[0] for v in got.values()] == [1024, 512, 256]
    assert [v[2] for v in got.values()] == [4.0, 8.0, 16.0]
    assert [v[3] for v in got.values()] == [43, 11, 2]


def test_port_modules_import_no_reference():
    root = os.path.join(os.path.dirname(__file__), "..", "dpwa_tpu_torch", "hier")
    for name in os.listdir(root):
        if name.endswith(".py"):
            with open(os.path.join(root, name)) as f:
                for line in f:
                    assert not line.lstrip().startswith(("import dpwa_tpu.", "from dpwa_tpu.",
                                                         "import jax", "from jax")), (name, line)
