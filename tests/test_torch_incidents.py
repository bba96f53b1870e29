"""The port's incident plane against the reference's: the two
``IncidentPlane`` classes fed the same scripted ``observe_round`` sequences
(after the reference's own unit tests) return the same results and emit the
same alert and incident records (apart from ``t``), with the same snapshots,
JSONL files and ``/metrics`` text.  Timing-dependent detectors (``slo_burn``,
``conv_stall``) are fed scripted wall times and ``rel_rms`` values."""

import json

import pytest

from dpwa_tpu.config import ObsConfig as RefObsConfig
from dpwa_tpu.obs import incidents as ref_incidents
from dpwa_tpu.obs import prometheus as ref_prometheus
from dpwa_tpu_torch.config import ObsConfig
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.obs import incidents, prometheus

PARTITION = {"event": "partition_entered", "component": [0, 1], "quorum_fraction": 0.5}
HEALED = {"event": "partition_healed"}
SICK = {"peers": {3: {"state": "quarantined", "quarantines": 1}}}
WELL = {"peers": {3: {"state": "healthy", "quarantines": 1}}}


def _failures(peer=3, n=3):
    return [(s, dict(outcome=Outcome.TIMEOUT, peer=peer)) for s in range(n)]


# name -> (ObsConfig overrides, [(step, observe_round kwargs)], alert kinds fired)
SCENARIOS = {
    "peer_failure_and_reset": ({}, [
        (0, dict(outcome=Outcome.REFUSED, peer=1)), (1, dict(outcome=Outcome.SUCCESS, peer=1)),
        (2, dict(outcome=Outcome.SHORT_READ, peer=1)), (3, dict(outcome=Outcome.CORRUPT, peer=1)),
        (4, dict(outcome=Outcome.TIMEOUT, peer=1)),
    ], ["peer_failure"]),
    "trust_burst": ({"incident_window": 8}, [
        (0, dict(outcome=Outcome.UNTRUSTED, peer=2)), (9, dict(outcome=Outcome.POISONED, peer=2)),
        (10, dict(outcome=Outcome.UNTRUSTED, peer=2)),
        (11, dict(events=[{"event": "trust_collapsed", "peer": 2}])),
    ], ["trust_burst"]),
    "straggler": ({}, [
        (0, dict(outcome=Outcome.SLOW, peer=1)), (1, dict(outcome=Outcome.BUSY, peer=1)),
        (2, dict(board={"peers": {1: {"state": "degraded", "degrades": 1}}})),
    ], ["straggler"]),
    "state_storm": ({"incident_storm_threshold": 3}, [
        (0, dict(board={"peers": {1: {"state": "quarantined", "quarantines": 1},
                                  2: {"state": "healthy", "quarantines": 0}}})),
        (1, dict(board={"peers": {1: {"state": "quarantined", "quarantines": 2},
                                  2: {"state": "quarantined", "quarantines": 1}}})),
        (2, dict(board={"peers": {1: {"state": "healthy", "quarantines": 2},
                                  2: {"state": "healthy", "quarantines": 1}}})),
    ], ["state_storm"]),
    "partition": ({}, [
        (5, dict(events=[PARTITION], partition_state="degraded", component=[0, 1])),
        (6, dict(partition_state="degraded", component=[0, 1])),
    ], ["partition"]),
    "partition_flap": ({"incident_window": 8}, [
        (2, dict(events=[PARTITION])), (5, dict(events=[HEALED], partition_state="ok")),
        (8, dict(events=[PARTITION])), (9, dict(partition_state="ok")),
    ], ["partition", "partition", "partition_flap"]),
    "staleness_storm": ({"incident_stale_storm": 3, "incident_window": 8}, [
        (0, dict(stale_peers=[2])), (1, dict(stale_peers=[2, 3])), (2, dict(stale_peers=[2])),
        *[(s, {}) for s in range(3, 12)], (12, dict(stale_peers=[1, 2, 3])),
    ], ["staleness_storm", "staleness_storm"]),
    "slo_burn": ({"incident_slo_warmup": 4, "incident_slo_rounds": 2}, [
        *[(s, dict(wall_s=0.01)) for s in range(4)], (4, dict(wall_s=0.1)),
        (5, dict(wall_s=0.1)), (6, dict(wall_s=0.1)), (7, dict(wall_s=0.01)),
    ], ["slo_burn"]),
    "stall": ({"incident_stall_window": 4}, [(s, dict(rel_rms=0.2)) for s in range(6)],
              ["conv_stall"]),
    "no_stall": ({"incident_stall_window": 4}, [
        *[(s, dict(rel_rms=0.8 / 2 ** s)) for s in range(4)],
        *[(s, dict(rel_rms=0.01)) for s in range(4, 12)],
    ], []),
    "priority_upgrade": ({}, [
        *_failures(n=2),
        (2, dict(events=[PARTITION], partition_state="degraded", component=[0, 1])),
        (3, dict(outcome=Outcome.UNTRUSTED, peer=1)), (4, dict(outcome=Outcome.POISONED, peer=1)),
    ], ["peer_failure", "partition", "trust_burst"]),
    "resolve": ({"incident_resolve_after": 4}, [
        *_failures(n=2), *[(s, dict(board=SICK)) for s in range(2, 10)],
        (10, dict(outcome=Outcome.SUCCESS, peer=3, board=WELL)),
        *[(s, dict(board=WELL)) for s in range(11, 20)],
        *[(s, dict(outcome=Outcome.TIMEOUT, peer=2)) for s in (20, 21)],
    ], ["peer_failure", "peer_failure"]),
    "clean_feed": ({}, [
        (s, dict(outcome=Outcome.SUCCESS, peer=1 + s % 3,
                 board={"peers": {i: {"state": "healthy", "quarantines": 0} for i in (1, 2, 3)}},
                 rel_rms=0.5 / (1 + s), wall_s=0.01, partition_state="ok"))
        for s in range(40)
    ], []),
}


def _planes(over, **kw):
    return (incidents.IncidentPlane(0, 4, ObsConfig(incidents=True, **over), **kw),
            ref_incidents.IncidentPlane(0, 4, RefObsConfig(incidents=True, **over), **kw))


def _untimed(recs):
    return [{k: v for k, v in r.items() if k != "t"} for r in recs]


def _snapshot(plane):
    snap = plane.snapshot()
    snap["recent_alerts"] = _untimed(snap["recent_alerts"])
    return snap


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_feed_emits_the_reference_records(name):
    over, feed, fired = SCENARIOS[name]
    mine, ref = _planes(over)
    alerts = []
    for step, kw in feed:
        got = mine.observe_round(step, **kw)
        assert got == ref.observe_round(step, **kw), (name, step)
        alerts += got["alerts"]
        assert _untimed(mine.pop_records()) == _untimed(ref.pop_records()), (name, step)
        assert _snapshot(mine) == _snapshot(ref), (name, step)
    assert alerts == fired
    if name == "resolve":
        closed = mine.snapshot()["closed"]
        assert [c["resolved_step"] for c in closed] == [13]
    if name == "priority_upgrade":
        snap = mine.snapshot()
        assert snap["opened_total"] == 1 and snap["open"][0]["kind"] == "partition"


def test_incident_file_equal_reference_with_me_substitution(tmp_path):
    files = []
    for tag, cls, cfg in (("mine", incidents.IncidentPlane, ObsConfig),
                          ("ref", ref_incidents.IncidentPlane, RefObsConfig)):
        path = str(tmp_path / (tag + "-{me}.jsonl"))
        p = cls(2, 4, cfg(incidents=True, incident_path=path, incident_resolve_after=2))
        for step, kw in [(0, dict(outcome=Outcome.TIMEOUT, peer=0)),
                         (1, dict(outcome=Outcome.TIMEOUT, peer=0)),
                         (2, dict(outcome=Outcome.SUCCESS, peer=0)), *[(s, {}) for s in range(3, 8)]]:
            p.observe_round(step, **kw)
        p.close()
        with open(tmp_path / f"{tag}-2.jsonl") as f:
            files.append(_untimed(json.loads(line) for line in f))
    assert files[0] == files[1]
    assert [r.get("status", r["record"]) for r in files[0]] == ["alert", "open", "resolved"]


def test_incident_register_metrics_renders_reference_families():
    mine, ref = _planes({})
    for plane in (mine, ref):
        for step, kw in _failures(n=2) + [(2, dict(outcome=Outcome.SLOW, peer=1)),
                                          (3, dict(outcome=Outcome.SLOW, peer=1))]:
            plane.observe_round(step, **kw)
    regs = prometheus.MetricsRegistry(), ref_prometheus.MetricsRegistry()
    incidents.register_metrics(regs[0], mine)
    ref_incidents.register_metrics(regs[1], ref)
    text = regs[0].render()
    assert text == regs[1].render()
    assert 'dpwa_alerts_total{kind="peer_failure"} 1' in text and "dpwa_incident_severity 2" in text


def test_tables_match_the_reference_and_a_topology_raises():
    """The tables match, and a topology (once refused) arms
    ``island_partition``: the same cut is the generic ``partition``
    without one."""
    from dpwa_tpu.hier import Topology as RefTopology
    from dpwa_tpu_torch.hier import Topology

    assert incidents.ALERT_KINDS == ref_incidents.ALERT_KINDS
    assert incidents.KIND_PRIORITY == ref_incidents.KIND_PRIORITY
    cut = dict(events=[{"event": "partition_entered", "component": [0, 1], "quorum_fraction": 0.5}],
               partition_state="degraded", component=[0, 1])
    mine = incidents.IncidentPlane(0, 4, ObsConfig(incidents=True), topology=Topology.uniform(2, 2))
    ref = ref_incidents.IncidentPlane(0, 4, RefObsConfig(incidents=True),
                                      topology=RefTopology.uniform(2, 2))
    assert mine.observe_round(5, **cut) == ref.observe_round(5, **cut)
    assert _snapshot(mine) == _snapshot(ref)
    assert [a["kind"] for a in mine.snapshot()["recent_alerts"]] == ["island_partition"]
    flat = incidents.IncidentPlane(0, 4, ObsConfig(incidents=True))
    assert flat.observe_round(5, **cut)["alerts"] == ["partition"]
