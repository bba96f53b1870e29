"""The observability plane on the TCP transport, in port and mixed
``dpwa_tpu`` / ``dpwa_tpu_torch`` groups: frames and merges with the
``obs:`` block off and on, each package decoding the other's ``DPWT``
trailers, the trailers byte for byte on replicas of small integers, the
cross-peer trace join, the healthz routes, the snapshot's obs keys, a
chaos-kill soak's incident, the adapter's traced rounds and the pipeline's
span-derived hidden fraction.  Every node binds port 0 and is wired with
``set_peer_port``."""

import dataclasses
import json
import os
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from dpwa_tpu.config import ObsConfig as RefObsConfig
from dpwa_tpu.config import config_from_dict as ref_config_from_dict
from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch.config import ObsConfig, config_from_dict, make_local_config
from dpwa_tpu_torch.obs import wire
from dpwa_tpu_torch.parallel import tcp

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)

from tools import incident_report, schema_check, trace_report  # noqa: E402

FLOWCTL_OFF = {"flowctl": {"enabled": False}}
ALL_ON = dict(trace=True, sketch=True, metrics=True, incidents=True, recorder=True)


def _ephemeral(cfg):
    return dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))


def _group(kinds, port_kw=None, **kw):
    """Nodes of ``kinds`` ("ref" / "port") under one config, wired."""
    n = len(kinds)
    ref_cfg = _ephemeral(ref_config(n, base_port=0, **kw))
    port_cfg = _ephemeral(make_local_config(n, **{**kw, **(port_kw or {})}))
    nodes = []
    try:
        for i, kind in enumerate(kinds):
            nodes.append(ref_tcp.TcpTransport(ref_cfg, f"node{i}") if kind == "ref"
                         else tcp.TcpTransport(port_cfg, f"node{i}", device="cpu"))
        for t in nodes:
            for i, other in enumerate(nodes):
                t.set_peer_port(i, other.port)
    except BaseException:
        _close(nodes)
        raise
    return nodes


def _close(nodes):
    for t in nodes:
        t.close()


def _await_serve_spans(nodes, want, timeout_s=30.0):
    """Wait until the nodes' tracers hold ``want`` serve spans (one a
    successful fetch).  A server notes its span on its Rx thread after the
    frame is sent, so the fetcher can finish first; a node closed before
    its Rx thread runs would drop the span."""
    deadline = time.monotonic() + timeout_s
    while True:
        held = sum(t.tracer.stage_summary().get("serve", {}).get("n", 0) for t in nodes)
        if held >= want or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert held >= want, f"{held} serve spans for {want} successful fetches"


def _drive(nodes, kinds, rounds, d=256, seed=1, vecs=None, sleep_s=0.0, loss=0.0,
           outcomes=None):
    """Lock-step rounds (each node exchanges in turn at clock = step);
    the final replicas as numpy arrays.  ``outcomes`` (a list) gets each
    exchange's fetch outcome."""
    rng = np.random.RandomState(seed)
    if vecs is None:
        vecs = [rng.standard_normal(d).astype(np.float32) for _ in nodes]
    for step in range(rounds):
        for i, t in enumerate(nodes):
            v = vecs[i] if kinds[i] == "ref" else torch.from_numpy(vecs[i].copy())
            merged, _alpha, _p = t.exchange(v, float(step), loss, step)
            vecs[i] = np.asarray(merged, np.float32).copy()
            if outcomes is not None:
                outcomes.append(t.last_round.get("outcome"))
        if sleep_s:
            time.sleep(sleep_s)
    return vecs


def _payload(t):
    with t.server._lock:
        return t.server._payload


def test_obs_off_frames_unchanged_and_obs_on_adds_one_trailer():
    """Off: a port pair's served frames equal an all-reference pair's and
    no obs state exists.  On (trace and sketch), with the same seed and
    data: every frame is the off frame plus one DPWT trailer and every
    merged replica is bit-equal."""
    kw = dict(schedule="ring", timeout_ms=2000, factor=0.3, **FLOWCTL_OFF)
    runs = {}
    for label, kinds, obs in (("ref_off", ("ref", "ref"), None), ("off", ("port", "port"), None),
                              ("on", ("port", "port"), {"trace": True, "sketch": True})):
        nodes = _group(kinds, **kw, **({"obs": obs} if obs else {}))
        try:
            if label == "off":
                t = nodes[0]
                assert (t.tracer, t.sketchboard, t.metrics_registry, t.incidents,
                        t.flight) == (None,) * 5
                assert not t._obs_wire and "obs" not in t.health_snapshot()
            frames = []
            vecs = None
            for r in range(4):
                vecs = _drive(nodes, kinds, 1, vecs=vecs, seed=3)
                frames.append([_payload(t) for t in nodes])
            runs[label] = (frames, vecs)
        finally:
            _close(nodes)
    assert runs["off"][0] == runs["ref_off"][0]
    for off_round, on_round in zip(runs["off"][0], runs["on"][0]):
        for off, on in zip(off_round, on_round):
            assert on.startswith(off)
            assert wire.decode_obs(on[len(off):]) is not None
    for a, b in zip(runs["off"][1], runs["on"][1]):
        assert np.array_equal(a, b)


def test_dpwt_trailers_byte_equal_on_small_integer_replicas():
    """A port node and a reference node publishing the same small-integer
    replica under the same clock serve the same frame, DPWT trailer and
    sketch included, byte for byte."""
    kw = dict(schedule="ring", seed=9, membership={"enabled": False},
              obs={"trace": True, "sketch": True, "sketch_k": 32}, **FLOWCTL_OFF)
    ref = ref_tcp.TcpTransport(_ephemeral(ref_config(2, base_port=0, **kw)), "node1")
    mine = tcp.TcpTransport(_ephemeral(make_local_config(2, **kw)), "node1", device="cpu")
    try:
        for clock in (3.0, 7.0):
            v = np.random.default_rng(int(clock)).integers(-6, 7, 5003).astype(np.float32)
            ref.publish(v, clock, 0.25)
            mine.publish(torch.from_numpy(v), clock, 0.25)
            a, b = _payload(mine), _payload(ref)
            assert a == b
            frame = wire.decode_obs(a[-(wire.OBS_HEADER_SIZE + 4 * 32):])
            assert frame.trace_id == f"1:{int(clock)}" and frame.sketch.shape == (32,)
    finally:
        mine.close()
        ref.close()


def test_mixed_ring_decodes_each_others_trailers_and_joins_its_traces(tmp_path):
    """A ring of two reference and two port nodes (the port's on the
    reactor Rx server) with trace and sketch on: every node's sketch board
    holds its partners' sketches, every traced round names the trace ID its
    partner published, tools/trace_report.py joins the four streams with
    completeness 1.0, and the convergence estimate falls."""
    kinds = ("ref", "port", "ref", "port")
    obs = {"trace": True, "sketch": True, "trace_path": str(tmp_path / "trace.jsonl")}
    nodes = _group(kinds, port_kw={"rx_server": "reactor"}, schedule="ring", timeout_ms=2000,
                   obs=obs, **FLOWCTL_OFF)
    try:
        outcomes = []
        _drive(nodes, kinds, 8, outcomes=outcomes)
        _await_serve_spans(nodes, outcomes.count("success"))
        for i, t in enumerate(nodes):
            snap = t.sketchboard.snapshot()
            assert snap["peers_seen"] >= 1 and snap["rms"] is not None, i
        assert type(nodes[1].server).__name__ == "ReactorPeerServer"
    finally:
        _close(nodes)
    recs = trace_report.load_traces([str(tmp_path / "trace.jsonl")])
    rounds = [r for r in recs if r["kind"] == "round" and r.get("outcome") == "success"]
    assert {r["me"] for r in rounds} == {0, 1, 2, 3}
    for r in rounds:  # the partner published this step's clock, or not yet
        origin, seq = r["remote_trace_id"].split(":")
        assert int(origin) == r["partner"] and int(seq) in (r["step"] - 1, r["step"])
    assert {r["me"] for r in recs if r["kind"] == "serve"} == {0, 1, 2, 3}
    rep = trace_report.build_report(recs)
    assert rep["join"]["successes"] > 0 and rep["join"]["completeness"] == 1.0
    conv = rep["convergence"]
    assert conv and conv[-1]["rms_mean"] < conv[0]["rms_mean"]
    assert schema_check.check_file(str(tmp_path / "trace.jsonl"))[1] == []


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.headers["Content-Type"], r.read().decode()


def _families(text):
    return sorted(line.split()[2] for line in text.splitlines() if line.startswith("# TYPE "))


def test_endpoints_and_snapshot_keys_equal_reference(tmp_path):
    """A mixed pair with every facility on: ``/metrics`` parses and holds
    the reference node's families, ``/incidents`` and ``/flightdump`` answer
    with the reference's keys, and ``health_snapshot``'s ``obs`` (its
    convergence and trace) and ``incidents`` keys are the reference's."""
    obs = dict(ALL_ON, incident_path=str(tmp_path / "inc-{me}.jsonl"),
               recorder_path=str(tmp_path / "flight-{me}.jsonl"))
    kinds = ("port", "ref")
    nodes = _group(kinds, schedule="ring", timeout_ms=2000, obs=obs,
                   health={"healthz_port": 0})
    try:
        _drive(nodes, kinds, 4)
        docs = []
        for t in nodes:
            ctype, text = _get(t.healthz.port, "/metrics")
            assert ctype.startswith("text/plain; version=0.0.4")
            for line in text.splitlines():
                assert line.startswith("#") or len(line.rsplit(" ", 1)) == 2
            inc = json.loads(_get(t.healthz.port, "/incidents")[1])
            dump = json.loads(_get(t.healthz.port, "/flightdump")[1])
            health = json.loads(_get(t.healthz.port, "/healthz")[1])
            docs.append((_families(text), sorted(inc), sorted(dump), health))
        assert docs[0][:3] == docs[1][:3]
        assert {"dpwa_peer_state", "dpwa_membership_incarnation", "dpwa_trust_score",
                "dpwa_flowctl_deadline_ms", "dpwa_admission_sheds_total",
                "dpwa_wire_frames_total", "dpwa_disagreement_rms",
                "dpwa_trace_stage_seconds_total", "dpwa_incidents_open"} <= set(docs[0][0])
        mine, theirs = docs[0][3], docs[1][3]
        assert sorted(mine["obs"]) == sorted(theirs["obs"]) == ["convergence", "trace"]
        assert sorted(mine["obs"]["convergence"]) == sorted(theirs["obs"]["convergence"])
        assert sorted(mine["obs"]["trace"]) == sorted(theirs["obs"]["trace"])
        assert sorted(mine["incidents"]) == sorted(theirs["incidents"])
        assert mine["incidents"]["opened_total"] == theirs["incidents"]["opened_total"] == 0
    finally:
        _close(nodes)
    assert os.path.exists(tmp_path / "flight-0.jsonl")


def test_chaos_kill_soak_opens_one_peer_down_incident(tmp_path):
    """A 4-node mixed soak (after the reference's chaos-kill test) with
    node 2, a port node, down for rounds 4-13: tools/incident_report.py
    finds exactly one peer_down incident, opened within 3 rounds and naming
    the victim, and every file passes tools/schema_check.py."""
    victim, start = 2, 4
    kinds = ("ref", "port", "port", "ref")
    obs = dict(incidents=True, incident_path=str(tmp_path / "inc-{me}.jsonl"), recorder=True,
               recorder_path=str(tmp_path / "flight-{me}.jsonl"))
    nodes = _group(kinds, schedule="ring", seed=2, timeout_ms=300, health={"jitter_rounds": 2},
                   chaos={"enabled": True, "seed": 5, "down_windows": [(victim, start, 14)]},
                   obs=obs)
    try:
        vecs = [np.full(128, i + 1.0, np.float32) for i in range(4)]
        _drive(nodes, kinds, 24, vecs=vecs, loss=0.1)
    finally:
        _close(nodes)
    paths = sorted(str(p) for pat in ("inc-*.jsonl", "flight-*.jsonl")
                   for p in tmp_path.glob(pat))
    for p in paths:
        assert schema_check.check_file(p)[1] == [], p
    rep = incident_report.build_report(incident_report.load_records(paths))
    assert len(rep["clusters"]) == 1, rep["clusters"]
    c = rep["clusters"][0]
    assert (c["kind"], c["severity"], c["implicated_peers"]) == ("peer_down", "critical", [victim])
    assert c["opened_step"] - start <= 3
    assert c["first_cause"]["alert"] == "peer_failure"


def test_adapter_rounds_are_traced(tmp_path):
    """The port's adapters call ``exchange_on_device``: each of their
    rounds is one trace record with the reference's stages, trace IDs and
    fields, and the merge its own stage."""
    from dpwa_tpu_torch.adapters.tcp_adapter import DpwaTcpAdapter

    cfg = _ephemeral(make_local_config(2, factor=0.5, obs={"trace": True, "sketch": True}))
    nodes = [DpwaTcpAdapter({"w": torch.full((8,), i + 1.0)}, f"node{i}", cfg, device="cpu")
             for i in range(2)]
    try:
        for a in nodes:
            for i, b in enumerate(nodes):
                a.transport.set_peer_port(i, b.transport.port)
        for _ in range(3):
            for a in nodes:
                a.update(0.5)
        recs = [r for r in nodes[0].transport.tracer.pop_records() if r["kind"] == "round"]
    finally:
        for a in nodes:
            a.close()
    assert [r["step"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert list(r["stages"]) == ["publish", "partner_resolve", "wire", "guard", "trust",
                                     "merge"]
        assert r["trace_id"] == f"0:{r['step'] + 1}" and r["outcome"] == "success"
        assert r["remote_trace_id"].startswith("1:") and r["alpha"] == 0.5
        assert {"partner", "sched_partner", "remapped", "nbytes", "disagreement_rms",
                "disagreement_rel"} <= set(r)


def test_pipeline_spans_agree_with_hidden_frac():
    """Under ``overlap_prefetch`` the span-derived hidden fraction agrees
    with ``wire_snapshot``'s within 10 points (the reference's bound), and
    the rounds name their prefetch slots."""
    kinds = ("port", "port")
    nodes = _group(kinds, schedule="ring", timeout_ms=4000, overlap_prefetch=True,
                   obs={"trace": True})
    try:
        _drive(nodes, kinds, 10, d=200_000, sleep_s=0.01)
        recs = []
        for t in nodes:
            recs.extend(t.tracer.pop_records())
        ovs = [t.wire_snapshot()["overlap"] for t in nodes]
        self_report = max(1.0 - sum(o["join_wait_s"] for o in ovs)
                          / sum(o["fetch_s"] for o in ovs), 0.0)
    finally:
        _close(nodes)
    rep = trace_report.build_report(recs)
    assert rep["overlap"]["prefetched"] > 0
    assert abs(rep["overlap"]["hidden_frac"] - self_report) < 0.10
    assert any("join_wait" in r["stages"] for r in recs if r["kind"] == "round")


BAD_BLOCKS = {
    "sketch_k": {"sketch_k": 0},
    "trace_every": {"trace_every": 0},
    "slo_factor": {"incident_slo_factor": 1.0},
    "stall_improve": {"incident_stall_improve": 1.0},
    "log_keep": {"log_keep": 0},
}


@pytest.mark.parametrize("name", [*sorted(BAD_BLOCKS), "valid"])
def test_obs_block_loads_and_validates_as_the_reference(name):
    raw = {"nodes": ["a", "b"], "obs": BAD_BLOCKS.get(name, dict(
        ALL_ON, sketch_k=16, trace_every=2, log_max_bytes=4096, log_keep=3))}
    if name == "valid":
        mine, theirs = config_from_dict(raw).obs, ref_config_from_dict(raw).obs
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs) and mine.enabled
        assert dataclasses.asdict(ObsConfig()) == dataclasses.asdict(RefObsConfig())
        assert not ObsConfig().enabled
        return
    with pytest.raises(ValueError) as theirs:
        ref_config_from_dict(raw)
    with pytest.raises(ValueError) as mine:
        config_from_dict(raw)
    assert str(mine.value) == str(theirs.value)
