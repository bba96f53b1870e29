"""The observability plane's records against the reference: the
``MetricsLogger`` files (apart from the ``t`` stamps), the tracer's records,
the Prometheus text of the registry and of every ported plane's
``register_metrics``, and the flight recorder's dumps, the crash dumps of a
subprocess included; and ``tools/schema_check.py`` on a live run's files."""

import json
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from dpwa_tpu import metrics as ref_metrics
from dpwa_tpu.config import FlowctlConfig as RefFlowctlConfig
from dpwa_tpu.config import HealthConfig as RefHealthConfig
from dpwa_tpu.config import MembershipConfig as RefMembershipConfig
from dpwa_tpu.config import TrustConfig as RefTrustConfig
from dpwa_tpu.flowctl import admission as ref_admission
from dpwa_tpu.flowctl import estimator as ref_estimator
from dpwa_tpu.health import scoreboard as ref_scoreboard
from dpwa_tpu.membership import manager as ref_membership
from dpwa_tpu.obs import prometheus as ref_prometheus
from dpwa_tpu.obs import recorder as ref_recorder
from dpwa_tpu.obs import trace as ref_trace
from dpwa_tpu.parallel import async_loop as ref_async
from dpwa_tpu.parallel import reactor as ref_reactor
from dpwa_tpu.recovery import guard as ref_guard
from dpwa_tpu.trust import manager as ref_trust
from dpwa_tpu_torch import metrics
from dpwa_tpu_torch.config import FlowctlConfig, HealthConfig, MembershipConfig, TrustConfig
from dpwa_tpu_torch.flowctl import admission, estimator
from dpwa_tpu_torch.health import scoreboard
from dpwa_tpu_torch.membership import manager as membership
from dpwa_tpu_torch.obs import prometheus, recorder, trace
from dpwa_tpu_torch.parallel import async_loop, reactor
from dpwa_tpu_torch.recovery import guard
from dpwa_tpu_torch.trust import manager as trust

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)

from tools import schema_check  # noqa: E402

OUTCOMES = ("success", "timeout", "refused", "busy", "slow", "success", "poisoned", "success")


def _lines(path, drop=("t",)):
    """A JSONL file's records without the keys in ``drop``."""
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in drop} for line in f]


def _health_snapshot():
    """A health snapshot with every plane's sub-document (the columns
    ``log_health`` flattens)."""
    peers = {p: {"state": "healthy", "suspicion": 0.5 * p, "quarantined_rounds": p,
                 "quarantines": 1, "attempts": 10 + p, "failures": p, "probe_attempts": 0,
                 "last_outcome": "success", "incarnation": p, "trust": 0.9,
                 "trust_verdict": "accept", "trust_damped": 1, "trust_rejected": 0,
                 "deadline_ms": 40.0 + p, "hedges": 1, "hedge_wins": 0, "busy": 0, "slow": 1}
             for p in (1, 2)}
    return {
        "me": 0, "round": 12, "peers": peers,
        "membership": {"incarnation": 3, "component": [0, 1, 2], "component_id": 0,
                       "partition_state": "ok"},
        "flowctl": {"hedges": 2, "hedge_wins": 1, "admission": {"shed_total": 4}},
        "wire": {"codec": "shard+topk", "wire_bytes": 100, "compression_ratio": 4.0,
                 "copies_per_frame": 0.0,
                 "overlap": {"occupancy": 0.5, "hidden_frac": 0.9, "prefetched": 3,
                             "straddled": 1},
                 "view": {"view_active": 2, "view_passive": 1, "view_digest_bytes": 40},
                 "shard": {"k": 4, "coverage": 0.75}},
        "reactor": {"loop_lag_ms": 0.2, "ready_depth": 1, "open": 2, "evicted": 0,
                    "busy_shed": 0},
        "obs": {"convergence": {"rms": 0.5, "rel_rms": 0.1, "peers_seen": 2}},
        "async": {"rounds": 5, "merges": 4, "stale_drops": 1, "dup_drops": 0, "shed": 0,
                  "fold_frames": 2, "staleness_hist": [3, 1, 0],
                  "peers": {1: {"merges": 3, "stale": 1, "pending": 0, "last_lag": 1}}},
    }


def _write_records(logger, as_tensor):
    """One of each record kind through ``logger``, the exchange record's
    arrays as tensors (the port) or numpy arrays (the reference)."""
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    info = types.SimpleNamespace(
        partner=conv(np.array([1, 0], np.int32)), alpha=conv(np.array([0.3, 0.7], np.float32)),
        participated=conv(np.array([True, False])))
    logger.log(0, _t=0.5, loss=np.float32(1.25), arr=np.arange(3), nested={"a": [1, 2]})
    logger.log_exchange(1, conv(np.array([0.5, 0.25], np.float32)), info, 400, t=1.0, lr=0.1)
    logger.log_health(2, _health_snapshot(), note="x")
    logger.log_event(2, "rollback", reason="nonfinite", restored=True)
    logger.log_exchange(3, conv(np.array([0.125, 1.0], np.float32)), info, 400, t=2.0)
    logger.log_tune(3, {"link": 1, "rung": 2})
    logger.log(5, _t=5.0, last=True)


def test_metrics_logger_files_equal_reference(tmp_path):
    """Every record kind, the deferred exchange records flushed in order,
    equal to the reference's file apart from ``t``."""
    mine = metrics.MetricsLogger(path=str(tmp_path / "mine.jsonl"))
    ref = ref_metrics.MetricsLogger(path=str(tmp_path / "ref.jsonl"))
    _write_records(mine, True)
    _write_records(ref, False)
    mine.close()
    ref.close()
    assert _lines(tmp_path / "mine.jsonl") == _lines(tmp_path / "ref.jsonl")
    assert len(_lines(tmp_path / "mine.jsonl")) == 7
    # Sampling: every=2 drops the odd steps of ordinary records only.
    with metrics.MetricsLogger(path=str(tmp_path / "m2.jsonl"), every=2) as m, \
            ref_metrics.MetricsLogger(path=str(tmp_path / "r2.jsonl"), every=2) as r:
        for lg in (m, r):
            for s in range(4):
                lg.log(s, _t=0.0, v=s)
                lg.log_event(s, "e")
    assert _lines(tmp_path / "m2.jsonl") == _lines(tmp_path / "r2.jsonl")


def test_metrics_logger_roll_cascade_equal_reference(tmp_path):
    """``max_bytes`` and ``keep``: the same files, line for line (stamps
    fixed, so the roll points are the same)."""
    for name, cls in (("mine", metrics.MetricsLogger), ("ref", ref_metrics.MetricsLogger)):
        os.makedirs(tmp_path / name)
        lg = cls(path=str(tmp_path / name / "m.jsonl"), max_bytes=300, keep=3)
        for s in range(40):
            lg.log(s, _t=float(s), payload="x" * (s % 7), k=s)
        lg.close()
    names = sorted(os.listdir(tmp_path / "mine"))
    assert names == sorted(os.listdir(tmp_path / "ref")) == [
        "m.jsonl", "m.jsonl.1", "m.jsonl.2", "m.jsonl.3"]
    for n in names:
        with open(tmp_path / "mine" / n) as a, open(tmp_path / "ref" / n) as b:
            assert a.read() == b.read()
    unbounded = metrics.MetricsLogger(path=str(tmp_path / "u.jsonl"))
    for s in range(40):
        unbounded.log(s, _t=0.0, payload="x" * 50)
    unbounded.close()
    assert not os.path.exists(tmp_path / "u.jsonl.1")


def test_metrics_logger_concurrent_writers(tmp_path):
    """Four threads logging through one rolling logger, with a fast switch
    interval: no torn line, no record lost or written twice."""
    path = str(tmp_path / "c.jsonl")
    lg = metrics.MetricsLogger(path=path, max_bytes=4096, keep=50)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(w):
            for i in range(150):
                if i % 3 == 0:
                    lg.log_event(i, "e", w=w, i=i)
                else:
                    lg.log(i, w=w, i=i)

        threads = [threading.Thread(target=work, args=(w,)) for w in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(prev)
        lg.close()
    seen = []
    for name in os.listdir(tmp_path):
        with open(tmp_path / name) as f:
            seen += [(r["w"], r["i"]) for r in map(json.loads, f)]
    assert sorted(seen) == sorted((w, i) for w in range(4) for i in range(150))


def _drive_tracer(tr):
    tr.note_serve("0:1", 100, 0.002)
    assert tr.begin_round(0)
    tr.mark("publish", 0.001)
    tr.mark("wire", 0.01)
    tr.mark("wire", 0.005)
    tr.set(trace_id="0:1", remote_trace_id="1:1", skipped=None)
    tr.end_round(partner=1, outcome="success", codec=None, nbytes=400)
    assert not tr.begin_round(1) and not tr.active
    tr.mark("merge", 1.0)  # no round active: nothing
    tr.set(alpha=0.5)
    tr.note_serve("0:2", 120, 0.003)
    assert tr.begin_round(2)
    tr.mark("merge", 0.0004)
    tr.end_round(partner=1, outcome="timeout")
    tr.note_serve("0:bad", 1, 0.001)


def test_tracer_records_and_summary_equal_reference(tmp_path):
    """Sampling (every 2), stage accumulation, serve spans drained before
    the round, the summary, and the JSONL stream (apart from ``t``)."""
    mine = trace.Tracer(0, every=2, path=str(tmp_path / "mine.jsonl"))
    ref = ref_trace.Tracer(0, every=2, path=str(tmp_path / "ref.jsonl"))
    _drive_tracer(mine)
    _drive_tracer(ref)
    assert mine.stage_summary() == ref.stage_summary()
    got = mine.pop_records()
    assert got == ref.pop_records()
    assert [r["kind"] for r in got] == ["serve", "round", "serve", "round", "serve"]
    assert got[1]["stages"] == {"publish": 0.001, "wire": 0.015}
    mine.close()
    ref.close()
    assert _lines(tmp_path / "mine.jsonl") == _lines(tmp_path / "ref.jsonl")


def _collectors(reg):
    reg.gauge_fn("dpwa_me", "This node's ring index.", lambda: 3)
    reg.register(lambda: [
        reg_family(reg, "a_total", "counter", 'help with \\ and\nnewline')
        .sample(5, {"peer": 2, "kind": 'q"uote\\'}).sample(None, {"peer": 3})
        .sample(True).sample(float("nan")).sample(1e20).sample(0.125).sample("x"),
        reg_family(reg, "a_total", "counter", "repeat").sample(2.0, {"z": 1, "a": 2}),
    ])
    reg.register(lambda: 1 / 0)  # a raising collector is skipped
    reg.gauge_fn("b", "", lambda: -3.5, mtype="untyped")


def reg_family(reg, name, mtype, help):
    mod = prometheus if isinstance(reg, prometheus.MetricsRegistry) else ref_prometheus
    return mod.Family(name, mtype, help)


def test_registry_render_byte_equal_to_reference():
    """Escaping, value formatting (bool, NaN, large, fractional, junk),
    None skipped, labels sorted, one header per family name, a raising
    collector skipped."""
    mine, ref = prometheus.MetricsRegistry(), ref_prometheus.MetricsRegistry()
    _collectors(mine)
    _collectors(ref)
    text = mine.render()
    assert text == ref.render()
    assert text.count("# TYPE a_total counter") == 1 and 'kind="q\\"uote\\\\"' in text


def _script_scoreboard(mod, cfg_cls):
    sb = mod.Scoreboard(4, 0, cfg_cls(), seed=3)
    for r, outcome in enumerate(OUTCOMES * 2):
        sb.record(1 + r % 3, outcome, latency_s=0.01 * (r % 4), nbytes=100, round=r)
    return sb


def _plane(kind, side):
    """``(register_metrics, plane)`` of ``kind`` on ``side`` ("port" or
    "ref"), in the same scripted state."""
    port = side == "port"
    if kind == "scoreboard":
        mod = scoreboard if port else ref_scoreboard
        return mod.register_metrics, _script_scoreboard(mod, HealthConfig if port else RefHealthConfig)
    if kind == "rollback_ring":
        mod = guard if port else ref_guard
        ring = mod.RollbackRing(3)
        for s in range(5):
            vec = np.full(8, float(s), np.float32)
            ring.push(torch.from_numpy(vec) if port else vec, s, float(s), 0.5)
        ring.rollback()
        return mod.register_metrics, ring
    if kind == "estimator":
        mod = estimator if port else ref_estimator
        est = mod.DeadlineEstimator((FlowctlConfig if port else RefFlowctlConfig)(), timeout_ms=400.0)
        for r, outcome in enumerate(OUTCOMES * 4):
            est.observe(1 + r % 2, outcome, latency_s=0.002 * (1 + r % 5), nbytes=1 << 16)
        est.note_hedge(1)
        est.note_hedge_win(1)
        return mod.register_metrics, est
    if kind == "admission":
        mod = admission if port else ref_admission
        adm = mod.AdmissionController((FlowctlConfig if port else RefFlowctlConfig)(
            max_connections=2))
        for host in ("a", "a", "b", "a"):
            adm.admit(host)
        adm.release("a")
        adm.reserve_bytes(1000)
        adm.note_eviction()
        return mod.register_metrics, adm
    if kind == "membership":
        mod = membership if port else ref_membership
        sb = _script_scoreboard(scoreboard if port else ref_scoreboard,
                                HealthConfig if port else RefHealthConfig)
        mgr = mod.MembershipManager(4, 0, sb, (MembershipConfig if port else RefMembershipConfig)(),
                                    seed=3)
        for r in range(12):
            mgr.end_round(r)
        return mod.register_metrics, mgr
    if kind == "trust":
        mod = trust if port else ref_trust
        mgr = mod.TrustManager(4, 0, (TrustConfig if port else RefTrustConfig)(min_window=2))
        rng = np.random.default_rng(5)
        local = rng.standard_normal(256).astype(np.float32)
        for r in range(8):
            remote = (local + 0.01 * rng.standard_normal(256)).astype(np.float32)
            if r == 6:
                remote = -50 * remote  # a sign-flipped blow-up
            as_in = torch.from_numpy if port else (lambda a: a)
            mgr.screen(1 + r % 2, as_in(remote), float(r + 1), as_in(local), round=r)
        return mod.register_metrics, mgr
    if kind == "async":
        snap = {"peers": {1: {"merges": 4, "stale": 1, "pending": 2, "last_lag": 1},
                          2: {"merges": 0, "stale": 3, "pending": 0, "last_lag": None}},
                "staleness_hist": [2, 1, 1, 0, 0, 3], "rounds": 9, "fold_frames": 2,
                "pending_wait_s": 0.012345}
        mod = async_loop if port else ref_async
        return mod.register_metrics, types.SimpleNamespace(snapshot=lambda: snap)
    snap = {"loop_lag_ms": 0.125, "ready_depth": 2, "open": 3, "peak_open": 7,
            "accepted": 40, "evicted": 1, "busy_shed": 2, "frames": 33, "relay_pending": 0}
    mod = reactor if port else ref_reactor
    return mod.register_metrics, types.SimpleNamespace(reactor_snapshot=lambda: snap)


PLANES = ("scoreboard", "rollback_ring", "estimator", "admission", "membership", "trust",
          "async", "reactor")


@pytest.mark.parametrize("kind", PLANES)
def test_register_metrics_renders_reference_families(kind):
    """Each ported plane's collector, fed the same scripted state as the
    reference's (the async engine's and the reactor's snapshots scripted
    directly), renders the reference's text byte for byte."""
    texts = []
    for side, reg in (("port", prometheus.MetricsRegistry()),
                      ("ref", ref_prometheus.MetricsRegistry())):
        register, plane = _plane(kind, side)
        register(reg, plane)
        texts.append(reg.render())
    assert texts[0] == texts[1]
    assert texts[0].count("# TYPE ") >= 3


def test_flight_recorder_dumps_equal_reference(tmp_path):
    """The bounded ring, the ``{me}`` path, a stray numpy value coerced,
    the dump counter; an empty ring dumps nothing; equal to the reference's
    dump apart from ``t``."""
    dumps = []
    for mod in (recorder, ref_recorder):
        empty = mod.FlightRecorder(1, rounds=4, path=str(tmp_path / f"e-{mod.__name__}.jsonl"))
        assert empty.dump("test") is None
        rec = mod.FlightRecorder(1, rounds=4, path=str(tmp_path / (mod.__name__ + "-{me}.jsonl")))
        for s in range(7):
            rec.note_round(s, partner=2, outcome=OUTCOMES[s], rel_rms=np.float32(0.25) if s else None,
                           nbytes=np.int64(4096), trust={"verdict": "accept"})
        path = rec.dump("incident", 5)
        assert path.endswith("-1.jsonl")
        rec.dump("close")
        snap = rec.snapshot()
        dumps.append((_lines(path), {k: v for k, v in snap.items() if k != "path"}))
    assert dumps[0] == dumps[1]
    assert [r["step"] for r in dumps[0][0]] == [6, 3, 4, 5, 6] and dumps[0][1]["dumps"] == 2


_CRASH = """
import os, signal, sys
sys.path.insert(0, {root!r})
from dpwa_tpu_torch.obs.recorder import FlightRecorder
rec = FlightRecorder(0, rounds=16, path={path!r})
rec.arm_crash_dump()
for step in range(10):
    rec.note_round(step, outcome="success", partner=1)
{die}
"""


@pytest.mark.parametrize("die", ["sigterm", "atexit"])
def test_flight_recorder_crash_dumps_in_a_subprocess(tmp_path, die):
    """A process that is sent SIGTERM, or exits without closing, leaves
    the whole ring behind (the reference's crash-dump contract)."""
    path = str(tmp_path / "crash.jsonl")
    kill = "os.kill(os.getpid(), signal.SIGTERM)" if die == "sigterm" else ""
    proc = subprocess.run([sys.executable, "-c", _CRASH.format(root=os.path.abspath(REPO),
                                                               path=path, die=kill)],
                          capture_output=True, timeout=60)
    assert proc.returncode == (-15 if die == "sigterm" else 0), proc.stderr
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["reason"] == die and len(lines) == 11
    assert schema_check.check_file(path)[1] == []


def test_schema_check_passes_on_live_records(tmp_path):
    """Two port adapters on the CPU with every obs facility on and the
    adapters' metrics files: tools/schema_check.py accepts every file."""
    import dataclasses

    from dpwa_tpu_torch.adapters.tcp_adapter import DpwaTcpAdapter
    from dpwa_tpu_torch.config import make_local_config

    obs = dict(trace=True, sketch=True, metrics=True, incidents=True, recorder=True,
               trace_path=str(tmp_path / "trace.jsonl"),
               incident_path=str(tmp_path / "inc-{me}.jsonl"),
               recorder_path=str(tmp_path / "flight-{me}.jsonl"))
    cfg = make_local_config(2, factor=0.5, obs=obs)
    cfg = dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))
    params = [{"w": torch.full((4, 3), float(i)), "b": torch.zeros(3)} for i in range(2)]
    nodes = [DpwaTcpAdapter(params[i], f"node{i}", cfg, device="cpu", health_every=2,
                            metrics=str(tmp_path / f"metrics-{i}.jsonl")) for i in range(2)]
    try:
        for a in nodes:
            for i, b in enumerate(nodes):
                a.transport.set_peer_port(i, b.transport.port)
        for _ in range(4):
            for a in nodes:
                a.update(0.5)
    finally:
        for a in nodes:
            a.close()
    files = sorted(os.listdir(tmp_path))
    assert {"trace.jsonl", "metrics-0.jsonl", "flight-0.jsonl", "flight-1.jsonl"} <= set(files)
    for name in files:  # a clean run's incident files are empty
        n, errors = schema_check.check_file(str(tmp_path / name))
        assert (n > 0 or name.startswith("inc-")) and errors == [], (name, errors[:3])
    kinds = {r.get("record") for r in _lines(tmp_path / "metrics-0.jsonl")}
    assert {None, "health"} <= kinds  # an exchange record carries no "record" key
    exchange = [r for r in _lines(tmp_path / "metrics-0.jsonl") if "record" not in r]
    assert [r["step"] for r in exchange] == [0, 1, 2, 3]
    assert all(r["outcome"] == "success" for r in exchange)
