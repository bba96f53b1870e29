"""The port's membership plane against the reference's, on the CPU: the
partition and its heal.

Each test names the test of ``tests/test_membership.py`` it mirrors.

- ``relay_draw`` and ``heal_draw`` bit-equal over seeds, and the heal's
  merge rounded as numpy rounds it.
- A 4-node partition, adapters mixed ref/port/port/ref and
  port/ref/ref/port lock-step against an all-reference group: the cross
  links {0,1}|{2,3} point at a closed port on every node for rounds
  ``SPLIT..HEAL`` (so relays see the partition too); every round's
  decisions, membership events, degraded flag, merged replica, and the
  heal's donor and reconciled replica equal the reference's
  (``test_partition_detect_heal_in_process``,
  ``test_reconcile_heal_merges_returning_state``).
- Neither plane imports JAX or the reference, and a partial view in the
  config loads as the reference's.

Every socket binds port 0 and peers are wired with ``set_peer_port``.
"""

import dataclasses
import json
import socket

import numpy as np
import pytest
import torch

from dpwa_tpu.adapters.tcp_adapter import DpwaTcpAdapter as RefAdapter
from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu_torch.adapters.tcp_adapter import DpwaTcpAdapter, reconcile_merge
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.parallel import schedules

FLOWCTL_OFF = {"flowctl": {"enabled": False}}


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


@pytest.mark.parametrize("seed", [0, 5, 77, 123456])
def test_relay_and_heal_draws_bit_equal_to_reference(seed):
    for step in (0, 1, 17, 4096, 2**31 - 1):
        for me in range(5):
            for n in (1, 2, 3, 7):
                assert schedules.heal_draw(seed, step, me, n) == int(
                    ref_schedules.heal_draw(seed, step, me, n))
                for slot in range(3):
                    assert schedules.relay_draw(seed, step, me, slot, n) == int(
                        ref_schedules.relay_draw(seed, step, me, slot, n))


def test_reconcile_merge_rounds_as_numpy():
    """The heal's merge: two rounded float32 products and a rounded sum, as
    numpy's ``((1.0 - w) * x + w * y).astype(float32)``, bit for bit."""
    rng = np.random.default_rng(3)
    x, y = (rng.standard_normal(10000).astype(np.float32) for _ in range(2))
    for w in (0.5, 0.3, 2 / 3, 0.75, 1e-3):
        want = ((1.0 - w) * x + w * y).astype(np.float32)
        got = reconcile_merge(torch.from_numpy(x), torch.from_numpy(y), w).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), w


# -- a 4-node partition, mixed -----------------------------------------------------

SPLIT, HEAL, P_ROUNDS, DIM = 4, 14, 44, 96
P_CFG = dict(schedule="ring", interpolation="clock", factor=0.7, timeout_ms=1000, seed=11)
P_MEMBERSHIP = {"quorum_fraction": 0.75, "degraded_alpha_scale": 0.5}


def _partition_run(kinds, tmp_path):
    ref_cfg = _ephemeral(ref_config(4, base_port=0, membership=P_MEMBERSHIP, **P_CFG,
                                    **FLOWCTL_OFF))
    port_cfg = _ephemeral(make_local_config(4, membership=P_MEMBERSHIP,
                                            disabled_planes=("flowctl",), **P_CFG))
    tmp_path.mkdir(parents=True, exist_ok=True)
    target = np.linspace(-1.0, 1.0, DIM).astype(np.float32)
    rng = np.random.default_rng(2)
    vecs = [(target + rng.standard_normal(DIM)).astype(np.float32) for _ in range(4)]
    nodes = []
    try:
        for i, kind in enumerate(kinds):
            if kind == "ref":
                nodes.append(RefAdapter({"w": vecs[i]}, f"node{i}", ref_cfg,
                                        metrics=str(tmp_path / f"{kind}{i}.jsonl")))
            else:
                nodes.append(DpwaTcpAdapter({"w": torch.from_numpy(vecs[i])}, f"node{i}",
                                            port_cfg, device="cpu"))
        ports = [a.transport.port for a in nodes]
        closed = _closed_port()
        log = []
        for r in range(P_ROUNDS):
            for i, a in enumerate(nodes):
                for j in range(4):
                    cut = SPLIT <= r < HEAL and (i < 2) != (j < 2)
                    a.transport.set_peer_port(j, closed if cut else ports[j])
            for i, a in enumerate(nodes):
                loss = float(np.mean((vecs[i] - target) ** 2))
                step = (vecs[i] - 0.2 * (vecs[i] - target) / DIM).astype(np.float32)
                out = a.update(loss, {"w": step if kinds[i] == "ref" else torch.from_numpy(step)})
                vecs[i] = np.asarray(out["w"], np.float32).copy()
                t = a.transport
                lr = t.last_round
                log.append((r, i, lr["sched_partner"], lr["partner"], lr["remapped"],
                            lr["outcome"], lr.get("trust", {}).get("verdict"), a.last_alpha,
                            t.membership.degraded, vecs[i].view(np.int32).tobytes()))
        events = []
        for i, a in enumerate(nodes):
            if kinds[i] == "ref":
                a.close()
                with open(tmp_path / f"ref{i}.jsonl") as f:
                    recs = [json.loads(line) for line in f]
                events.append([{k: v for k, v in rec.items() if k not in ("t", "record")}
                               for rec in recs if rec.get("record") == "event"])
            else:
                events.append(json.loads(json.dumps(list(a.events))))
        return log, events
    finally:
        for a in nodes:
            a.close()


@pytest.mark.parametrize("kinds", [("ref", "port", "port", "ref"), ("port", "ref", "ref", "port")])
def test_mixed_partition_degrades_and_reconciles_as_reference(kinds, tmp_path):
    """Mirrors ``test_partition_detect_heal_in_process`` and
    ``test_reconcile_heal_merges_returning_state``."""
    want_log, want_events = _partition_run(("ref",) * 4, tmp_path / "ref")
    got_log, got_events = _partition_run(kinds, tmp_path / "mixed")
    for got, want in zip(got_log, want_log):
        assert got[:9] == want[:9], (got[:9], want[:9])
        assert got == want, got[:2]  # the merged replica, bit for bit
    assert got_events == want_events
    # The scenario did what it should: nodes went degraded, healed, and
    # reconciled against a drawn donor of the returning peers.
    flat = [e for evs in want_events for e in evs]
    kinds_seen = {e["event"] for e in flat}
    assert {"partition_entered", "partition_healed", "partition_reconciled"} <= kinds_seen
    assert any(row[8] for row in want_log) and not any(row[8] for row in want_log[-8:])
    assert any(row[5] == "refused" for row in want_log)
    reconciled = [e for e in flat if e["event"] == "partition_reconciled"]
    assert all(e["donor"] in e["returning"] for e in reconciled)
    assert any(set(e["returning"]) & {2, 3} for e in reconciled)


_IMPORT_PROBE = """
import sys
import dpwa_tpu_torch.membership, dpwa_tpu_torch.trust, dpwa_tpu_torch.parallel.tcp
import dpwa_tpu_torch.adapters.tcp_adapter
assert dpwa_tpu_torch.membership.MembershipManager and dpwa_tpu_torch.trust.TrustManager
bad = sorted(m for m in sys.modules if m in ("jax", "dpwa_tpu") or m.startswith(("jax.", "dpwa_tpu.")))
print("FORBIDDEN", bad)
"""


def test_membership_and_trust_import_neither_jax_nor_the_reference():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout


def test_view_on_raises_naming_the_partial_view():
    """The partial view is ported: a view that is on loads as the
    reference's ``ViewConfig``, and a bad one raises a ``ValueError`` naming
    its field; a ``topology:`` block loads (an ``enabled`` field is no
    field of it, in either package)."""
    from dpwa_tpu.config import config_from_dict as ref_config_from_dict
    from dpwa_tpu_torch.config import (
        IslandSpec, TopologyConfig, ViewConfig, config_from_dict, load_config)

    doc = {"nodes": ["a"], "membership": {"view": {"enabled": True, "state_cap": 12}}}
    view = config_from_dict(doc).membership.view
    assert isinstance(view, ViewConfig) and view.enabled
    assert dataclasses.asdict(view) == dataclasses.asdict(ref_config_from_dict(doc).membership.view)
    with pytest.raises(ValueError, match="view.state_cap"):
        config_from_dict({"nodes": ["a"], "membership": {"view": {"state_cap": 2}}})
    with pytest.raises(TypeError, match="enabled"):
        config_from_dict({"nodes": ["a"], "topology": {"enabled": False}})
    with pytest.raises(TypeError, match="enabled"):
        ref_config_from_dict({"nodes": ["a"], "topology": {"enabled": False}})
    hier_doc = {"nodes": ["a", "b"], "topology": {"islands": [["a"], ["b"]]}}
    assert config_from_dict(hier_doc).topology == TopologyConfig(
        islands=(IslandSpec("island0", ("a",)), IslandSpec("island1", ("b",))))
    cfg = load_config("examples/mnist/nodes.yaml")
    assert cfg.membership.enabled and cfg.trust.enabled and cfg.flowctl.enabled
    assert config_from_dict({"nodes": ["a"], "membership": {"view": {"enabled": False}}}).membership
