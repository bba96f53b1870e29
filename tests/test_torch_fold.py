"""B2's fold form and the fan-in fold round of the port's TCP transport,
held to the reference.

Mirrors ``tests/test_device_engine.py:290`` (``exchange_on_device_fold``
against sequential ``native.merge_out``) and the fold contract of
``dpwa_tpu/device/engine.py:189-211``.  On the CPU the fold runs its plain
twin: the k merges in a row, each B2's plain f32-frame form; it must be
bit-equal to k port merges and to the reference's ``native.merge_out``
chain and device-engine fold, at α ≠ 0.5, for d not a multiple of 4.  The
fan-in round over mixed frame kinds (f32, int8, bf16, top-k, shard) must
make the reference's decisions and bits, a poisoned and an untrusted frame
left out as the reference leaves them out.  Every socket binds port 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dpwa_tpu import native
from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.device import MergeEngine, reset_device_stats
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.device import engine
from dpwa_tpu_torch.ops import merge
from dpwa_tpu_torch.parallel import tcp

D = 4099  # not a multiple of 4


def _bits(v) -> bytes:
    return np.asarray(v, np.float32).tobytes()


def _rows(k: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(D).astype(np.float32)
    rows = [(rng.standard_normal(D) * (i + 1)).astype(np.float32) for i in range(k)]
    return x, rows


@pytest.mark.parametrize("alpha", [0.3, 0.7])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_fold_bit_equal_to_sequential_merges_and_reference(k, alpha):
    x, rows = _rows(k, 10 + k)
    alphas = [alpha * (1.0 - 0.05 * i) for i in range(k)]
    got = engine.fold(torch.from_numpy(x), [torch.from_numpy(r) for r in rows], alphas)
    seq = torch.from_numpy(x)
    ref = x
    for r, a in zip(rows, alphas):
        seq = engine.merge_dense(seq, torch.from_numpy(r), a)
        ref = native.merge_out(ref, r, a)
    import jax.numpy as jnp

    dev = MergeEngine().fold(jnp.asarray(x), rows, alphas)
    assert _bits(got) == _bits(seq) == _bits(ref) == _bits(dev)
    plain = merge.torch_fold_merge(torch.from_numpy(x), [torch.from_numpy(r) for r in rows], alphas)
    assert _bits(plain) == _bits(ref)


def test_fold_engine_contract():
    """A length mismatch raises; no frames return ``x`` itself; each fold
    counts one dispatch and its frames (the reference's ``fold_frames``)."""
    x, rows = _rows(3, 5)
    xt, rt = torch.from_numpy(x), [torch.from_numpy(r) for r in rows]
    with pytest.raises(ValueError):
        engine.fold(xt, rt, [0.3, 0.4])
    with pytest.raises(ValueError):
        engine.fold(xt, [torch.zeros(D - 1)], [0.3])
    with pytest.raises(ValueError):
        MergeEngine().fold(x, rows, [0.3, 0.4])
    engine.reset_stats()
    assert engine.fold(xt, [], []) is xt
    engine.fold(xt, rt, [0.3, 0.4, 0.6])
    assert engine.stats() == {"fold_dispatches": 1, "fold_frames": 3, "topk_merges": 0}
    assert merge.fold_merge(xt, [], []).data_ptr() != xt.data_ptr()


# The fan-in group: node0 fetches; each other node publishes its own wire.
WIRES = {
    1: dict(),
    2: dict(wire_dtype="int8"),
    3: dict(wire_dtype="bf16"),
    4: dict(wire_codec="topk", topk_fraction=0.25),
    5: dict(),
    6: dict(wire_dtype="int8"),
    7: dict(shard={"k": 4}),
}
PEERS = [1, 2, 3, 4, 5, 6, 7]
BASE = dict(schedule="ring", interpolation="clock", factor=1.0, timeout_ms=2000, seed=6,
            trust={"window": 16, "min_window": 4, "amnesty_rounds": 2})
FAN_D = 1000


def _ephemeral(cfg):
    return dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))


def _node(kind: str, i: int):
    kw = {**BASE, **WIRES.get(i, {})}
    if kind == "ref":
        return ref_tcp.TcpTransport(
            _ephemeral(ref_config(8, base_port=0, **kw, flowctl={"enabled": False})), f"node{i}")
    return tcp.TcpTransport(_ephemeral(make_local_config(8, **kw, disabled_planes=("flowctl",))),
                            f"node{i}", device="cpu")


def _fan_in(kinds, rounds=6, dead=None):
    """Node0 (``kinds[0]``) runs ``rounds`` fan-in rounds over PEERS (and
    itself); peer i publishes its wire each round, with the fetcher's clock
    (α 0.5 exactly) for the top-k peer; node5 serves a NaN at round 4,
    node6 its sign-flip at round 5, and ``dead`` is closed before round 1.
    Returns every round's merges, merged bits, outcomes and verdicts."""
    reset_device_stats()
    engine.reset_stats()
    nodes, log = [], []
    try:
        for i, kind in enumerate(kinds):
            nodes.append(_node(kind, i))
        for t in nodes:
            for i, other in enumerate(nodes):
                t.set_peer_port(i, other.port)
        rng = np.random.default_rng(9)
        target = np.linspace(-1.0, 1.0, FAN_D).astype(np.float32)
        noise = [rng.standard_normal(FAN_D).astype(np.float32) * 0.1 for _ in nodes]
        x = target + noise[0]
        for r in range(rounds):
            c = 10.0 + r
            if r == 1 and dead is not None:
                nodes[dead].close()
            for i in PEERS:
                if i == dead and r >= 1:
                    continue
                v = (target + noise[i] * 0.9 ** r).astype(np.float32)
                if i == 5 and r == 4:
                    v[7] = np.nan
                if i == 6 and r == 5:
                    v = -v
                served = v if kinds[i] == "ref" else torch.from_numpy(v)
                nodes[i].publish(served, c if i == 4 else c + i, 0.5)
            fetcher = nodes[0]
            if kinds[0] == "ref":
                import jax.numpy as jnp

                merged, merges = fetcher.exchange_on_device_fold(
                    jnp.asarray(x), c, 0.5, r, [0] + PEERS)
            else:
                merged, merges = fetcher.exchange_on_device_fold(
                    torch.from_numpy(x.copy()), c, 0.5, r, [0] + PEERS)
            x = np.asarray(merged, np.float32).copy()
            log.append((r, [(p, float(a)) for p, a in merges], x.tobytes()))
        return log
    finally:
        for t in nodes:
            t.close()


def test_fan_in_round_mixed_kinds_equals_reference():
    """Mixed frame kinds in arrival order (runs of f32 and int8 folded, a
    bf16, a top-k and a shard frame between them), the publishers mixed
    ref/port and the fetcher a port node: every round's merges (peer, α)
    and merged bits are an all-reference group's, the NaN frame and the
    sign-flip left out; two folds a round, one where a run lost a frame."""
    want = _fan_in(("ref",) * 8)
    kinds = ("port", "port", "ref", "port", "ref", "port", "ref", "port")
    got = _fan_in(kinds)
    for g, w in zip(got, want):
        assert g[:2] == w[:2], (g[:2], w[:2])
        assert g == w, g[0]
    assert [p for p, _a in got[4][1]] == [1, 2, 3, 4, 6, 7]  # node5's NaN: poisoned
    assert [p for p, _a in got[5][1]] == [1, 2, 3, 4, 5, 7]  # node6's flip: untrusted
    assert dict(got[0][1])[4] == 0.5
    assert engine.stats()["fold_dispatches"] == 10  # 2 a round; 1 in rounds 4 and 5


def test_fan_in_round_skips_self_and_a_dead_peer_as_the_reference():
    want = _fan_in(("ref",) * 8, rounds=3, dead=3)
    got = _fan_in(("port",) * 8, rounds=3, dead=3)
    assert got == want
    assert 3 not in [p for p, _a in got[2][1]]
