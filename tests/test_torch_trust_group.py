"""The port's trust plane in 4-node groups over TCP against the
reference's, on the CPU, and the adapter's leaf sizes.

Each test names the test of ``tests/test_trust.py`` it mirrors.

- The model's leaf sizes in the frame's order (SmallNet, ConvNet,
  ResNet-8) as the reference's, as the adapter hands them to the screen.
- 4-node groups, mixed ref/port/port/ref and port/ref/ref/port, lock-step
  against an all-reference group: node 3 serves the sign-flip, then the
  5× scale, of its replica; every round's outcome, verdict, α, merged
  replica and the quarantine rounds equal the reference's
  (``test_acceptance_byzantine_soak_quarantine_and_convergence``); and an
  honest group at every default plane bit-equal to a trust-off run
  (``test_trust_disabled_restores_seed_behavior``).

Every socket binds port 0 and peers are wired with ``set_peer_port``.
"""

import dataclasses
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.device import reset_device_stats
from dpwa_tpu.models.mnist import ConvNet as RefConvNet
from dpwa_tpu.models.mnist import SmallNet as RefSmallNet
from dpwa_tpu.models.resnet import CifarResNet as RefResNet
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu.utils.pytree import leaf_sizes as ref_leaf_sizes
from dpwa_tpu_torch import convert
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.parallel import tcp
from dpwa_tpu_torch.utils.pytree import leaf_sizes

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


MODELS = {
    "smallnet": lambda: (RefSmallNet(), (1, 8, 8, 1)),
    "convnet": lambda: (RefConvNet(), (1, 28, 28, 1)),
    "resnet8": lambda: (RefResNet(depth=8), (1, 8, 8, 3)),
}


@pytest.mark.parametrize("which", list(MODELS))
def test_leaf_sizes_in_the_frame_order_of_the_reference(which):
    """The adapter's ``set_trust_leaves``: the port's leaf sizes are the
    reference's ``leaf_sizes`` of the reference's tree, leaf for leaf."""
    model, shape = MODELS[which]()
    params = jax.tree.map(np.asarray, model.init(jax.random.key(1), jnp.zeros(shape))["params"])
    own = {k: torch.from_numpy(v) for k, v in convert.flax_to_torch(params).items()}
    assert leaf_sizes(own) == ref_leaf_sizes(params)


# -- 4-node groups, mixed ------------------------------------------------------------

ATTACK_FROM, SCALE_FROM, B_ROUNDS, B_DIM = 10, 22, 34, 64
B_CFG = dict(schedule="ring", interpolation="clock", factor=0.7, timeout_ms=1000, seed=6,
             trust={"window": 16, "min_window": 4},
             health={"jitter_rounds": 1, "quarantine_base_rounds": 4})


def _group(kinds, planes):
    kw = {**B_CFG, **planes}
    ref_cfg = _ephemeral(ref_config(4, base_port=0, **kw, **FLOWCTL_OFF))
    port_cfg = _ephemeral(make_local_config(4, **kw, disabled_planes=("flowctl",)))
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


def _byzantine_run(kinds, attack=True, planes=None):
    """Lock-step descent on a shared quadratic: every node publishes, then
    every honest node exchanges; node 3 exchanges honestly until
    ATTACK_FROM, then only publishes the sign-flip of its replica, and from
    SCALE_FROM its 5× scale.  Returns each honest round's decisions and
    merged replica, and the honest nodes' health snapshots."""
    # A reference node's health snapshot gains a "wire" section once the
    # reference's device merge engine has served a round anywhere in this
    # process (``TcpTransport.health_snapshot``): start from a fresh engine,
    # as the reference's own tests do.
    reset_device_stats()
    nodes = _group(kinds, planes or {})
    target = np.linspace(-1.0, 1.0, B_DIM).astype(np.float32)
    rng = np.random.default_rng(4)
    vecs = [(target + rng.standard_normal(B_DIM)).astype(np.float32) for _ in range(4)]
    as_in = lambda i, v: v if kinds[i] == "ref" else torch.from_numpy(v.copy())
    log = []
    try:
        for r in range(B_ROUNDS):
            vecs = [(v - 0.2 * (v - target) / B_DIM).astype(np.float32) for v in vecs]
            lying = attack and r >= ATTACK_FROM
            for i, t in enumerate(nodes):
                served = vecs[i]
                if i == 3 and lying:
                    served = (5.0 * served if r >= SCALE_FROM else -served).astype(np.float32)
                t.publish(as_in(i, served), r + 1.0 + i, 0.5)
            for i, t in enumerate(nodes):
                if i == 3 and lying:
                    continue
                merged, alpha, _ = t.exchange(as_in(i, vecs[i]), r + 1.0 + i, 0.5, r)
                vecs[i] = np.asarray(merged, np.float32).copy()
                lr = t.last_round
                log.append((r, i, lr["sched_partner"], lr["partner"], lr["remapped"],
                            lr["outcome"], lr.get("trust", {}).get("verdict"),
                            lr.get("trust", {}).get("alpha_scale"), float(alpha),
                            vecs[i].view(np.int32).tobytes()))
        snaps = []
        for t in nodes[:3]:
            snap = json.loads(json.dumps(t.health_snapshot(), sort_keys=True))
            for info in snap["peers"].values():
                info.pop("ewma_latency_ms", None)
                info.pop("ewma_throughput_mbps", None)
            snap.get("trust", {}).pop("baselines", None)  # medians of f32 sums
            snaps.append(snap)
        return log, snaps
    finally:
        for t in nodes:
            t.close()


@pytest.mark.parametrize("kinds", [("ref", "port", "port", "ref"), ("port", "ref", "ref", "port")])
def test_mixed_group_rejects_and_quarantines_a_byzantine_peer_as_reference(kinds):
    """Mirrors ``test_acceptance_byzantine_soak_quarantine_and_convergence``."""
    want_log, want_snaps = _byzantine_run(("ref",) * 4)
    got_log, got_snaps = _byzantine_run(kinds)
    for got, want in zip(got_log, want_log):
        assert got[:9] == want[:9], (got[:9], want[:9])
        assert got == want, got[:2]  # the merged replica, bit for bit
    assert len(got_log) == len(want_log)
    assert got_snaps == want_snaps
    # The attack did what it should: the nodes paired with node 3 rejected
    # it as untrusted, quarantined it, and merged none of its lies.
    lies = [e for e in want_log if e[0] >= ATTACK_FROM and e[3] == 3]
    assert {e[5] for e in lies} == {"untrusted"} and {e[1] for e in lies} == {0, 2}
    assert all(e[8] == 0.0 for e in lies)
    assert any(e[4] and e[2] == 3 for e in want_log)  # remapped away from it
    for i in (0, 2):
        peer = want_snaps[i]["peers"]["3"]
        assert peer["quarantines"] >= 1 and peer["trust_rejected"] >= 1 and peer["trust"] < 0.5


def test_honest_group_at_default_planes_bit_equal_to_trust_off():
    """Mirrors ``test_trust_disabled_restores_seed_behavior``: with no
    attacker, a mixed group at every default plane merges bit for bit as
    the same group with trust off (a fully trusted peer's scale is 1.0)."""
    kinds = ("ref", "port", "port", "ref")
    on_log, _ = _byzantine_run(kinds, attack=False)
    off_log, _ = _byzantine_run(kinds, attack=False, planes={"trust": {"enabled": False}})
    assert [e[:6] + e[8:] for e in on_log] == [e[:6] + e[8:] for e in off_log]
    assert {e[6] for e in on_log} == {"trusted"} and {e[7] for e in on_log} == {1.0}
