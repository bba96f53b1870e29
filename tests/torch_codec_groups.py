"""Groups of reference and port TCP nodes for the codec tests
(``tests/test_torch_codec_*.py``): built on port 0, wired with
``set_peer_port``, run lock-step on one thread.

:func:`run_group` drives a shared quadratic descent: every node publishes,
then every node exchanges; node ``liar`` (if any) from round ``lie_from``
publishes the sign-flip of its replica instead and does not exchange.  It
returns every exchange's decisions and merged replica, and each node's
wire snapshot (the keys the reference and the port share).
:func:`assert_support_matches_device_engine` holds a top-k merge against
the reference device engine's, whose product on the support is the host's
XLA's choice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.device import reset_device_stats
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.parallel import tcp

SNAPSHOT_KEYS = ("codec", "frames", "wire_bytes", "dense_bytes", "compression_ratio")
BASE = dict(schedule="ring", interpolation="clock", factor=0.7, timeout_ms=2000, seed=6,
            trust={"window": 16, "min_window": 4})


def _ephemeral(cfg):
    return dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))


def group(kinds, **kw):
    """Nodes of ``kinds`` ("ref" / "port") under one config, flowctl off."""
    cfg = {**BASE, **kw}
    ref_cfg = _ephemeral(ref_config(len(kinds), base_port=0, **cfg, flowctl={"enabled": False}))
    port_cfg = _ephemeral(make_local_config(len(kinds), **cfg, disabled_planes=("flowctl",)))
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


def run_group(kinds, rounds=12, d=1000, liar=None, lie_from=0, **kw):
    """``(log, snapshots)`` of a lock-step run (see the module docstring)."""
    reset_device_stats()
    nodes = group(kinds, **kw)
    target = np.linspace(-1.0, 1.0, d).astype(np.float32)
    rng = np.random.default_rng(4)
    vecs = [(target + rng.standard_normal(d)).astype(np.float32) for _ in kinds]
    as_in = lambda i, v: v.copy() if kinds[i] == "ref" else torch.from_numpy(v.copy())
    log = []
    try:
        for r in range(rounds):
            vecs = [(v - 0.2 * (v - target) / d).astype(np.float32) for v in vecs]
            lying = liar is not None and r >= lie_from
            for i, t in enumerate(nodes):
                served = -vecs[i] if (i == liar and lying) else vecs[i]
                t.publish(as_in(i, served), r + 1.0 + i, 0.5)
            for i, t in enumerate(nodes):
                if i == liar and lying:
                    continue
                merged, alpha, _ = t.exchange(as_in(i, vecs[i]), r + 1.0 + i, 0.5, r)
                vecs[i] = np.asarray(merged, np.float32).copy()
                lr, trust = t.last_round, t.last_round.get("trust", {})
                log.append((r, i, lr["partner"], lr["outcome"], trust.get("verdict"),
                            trust.get("alpha_scale"), trust.get("reasons"), float(alpha),
                            lr.get("codec"), (trust.get("codec"), trust.get("shard")),
                            vecs[i].tobytes()))
        snaps = []
        for t in nodes:
            snap = t.wire_snapshot()
            snaps.append({k: snap[k] for k in SNAPSHOT_KEYS})
        return log, snaps
    finally:
        for t in nodes:
            t.close()


def assert_group_equals_reference(kinds, **kw):
    """The group of ``kinds`` decides and merges as an all-reference one,
    round by round (outcomes, verdicts, α, the codec and the trust
    statistics' codec and shard keys, the merged replica), and its wire
    snapshots are the reference's; returns the reference's log."""
    want, want_snaps = run_group(("ref",) * len(kinds), **kw)
    got, got_snaps = run_group(kinds, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:10] == w[:10], (g[:10], w[:10])
        assert g == w, g[:2]  # the merged replica, bit for bit
    assert got_snaps == want_snaps
    return want


def _fma32(a, b, c):
    """fma(a, b, c) of float32 operands, through float64 (the product is
    exact there)."""
    return (np.float64(a) * b + np.float64(c)).astype(np.float32)


def assert_support_matches_device_engine(got, device, x, idx, values, alpha):
    """The port's top-k merge ``got`` of the row ``x`` against the reference
    device engine's (``build_topk`` / ``build_shard_topk``) ``device``, as
    float32 arrays: bit-equal off the support ``idx``; on it bit-equal where
    that engine fuses the same product as the port and the reference's host
    merge, ``fma(1-α, x, α·v)``, which it does at α = 0.5 (where both
    products agree) and on a host whose XLA fuses the local product.  On a
    host whose XLA fuses the other product, ``fma(α, v, (1-α)·x)``, the
    support must be exactly that."""
    bits = lambda t: np.asarray(t, np.float32).view(np.int32)
    idx = np.asarray(idx, np.int64)
    off = np.ones(x.size, bool)
    off[idx] = False
    assert np.array_equal(bits(got)[off], bits(device)[off]), alpha
    a = np.float32(alpha)
    b = np.float32(1) - a
    xs = x[idx]
    local = _fma32(b, xs, a * values)
    assert np.array_equal(bits(got)[idx], bits(local)), alpha
    if alpha == 0.5 or np.array_equal(bits(device)[idx], bits(local)):
        assert np.array_equal(bits(got), bits(device)), alpha
    else:
        assert np.array_equal(bits(device)[idx], bits(_fma32(a, values, b * xs))), alpha
