"""Barrier-free async rounds (``protocol.async_rounds``) of the port's TCP
transport, held to the reference.

Mirrors ``tests/test_async.py``: the staleness damping exact at each lag
and composed with the trust damping, the drop strictly past
``max_staleness`` recorded as ``stale``, the publish-clock dedup guard
(latched only once the screens pass, a duplicate charged ``stale``), the
shard merge on its slice only, the block off byte-identical to lock-step,
and a scripted soak under a ``VirtualClock``.  Frames come from real
servers through each package's own ``_wire_fetch`` (every socket on port
0); a script decides in which round each is offered (``offer``), with the
reference's ``fetch_probability: 0.0`` keeping live slots out.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.device import reset_device_stats
from dpwa_tpu.flowctl.vclock import VirtualClock as RefClock
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu.parallel.async_loop import AsyncExchangeEngine as RefEngine
from dpwa_tpu.parallel.schedules import async_drain_draw as ref_drain_draw
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.flowctl.vclock import VirtualClock
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.health.scoreboard import PeerState
from dpwa_tpu_torch.parallel import tcp
from dpwa_tpu_torch.parallel.async_loop import AsyncExchangeEngine
from dpwa_tpu_torch.parallel.schedules import async_drain_draw

SCRIPTED = dict(fetch_probability=0.0)
BASE = dict(schedule="ring", interpolation="clock", factor=0.7, timeout_ms=2000, seed=6)


def _ephemeral(cfg):
    return dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))


def _group(kinds, **kw):
    cfg = {**BASE, **kw}
    n = len(kinds)
    ref_cfg = _ephemeral(ref_config(n, base_port=0, **cfg, flowctl={"enabled": False}))
    port_cfg = _ephemeral(make_local_config(n, **cfg, disabled_planes=("flowctl",)))
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


def _close(nodes):
    for t in nodes:
        t.close()


def _is_ref(t) -> bool:
    return isinstance(t, ref_tcp.TcpTransport)


def _as_in(t, v):
    return v.copy() if _is_ref(t) else torch.from_numpy(v.copy())


def _raw(t, peer, vec, clock, loss=0.0):
    """A scripted successful f32 fetch in ``t``'s package's raw layout."""
    vec = np.asarray(vec, np.float32)
    if _is_ref(t):
        return (int(peer), (vec, float(clock), float(loss)), Outcome.SUCCESS, 0.001, vec.nbytes,
                None, None, False, None)
    return (int(peer), (torch.from_numpy(vec.copy()), float(clock), float(loss)), Outcome.SUCCESS,
            0.001, vec.nbytes, [], None, False, None)


def _fetched(t, peer, step):
    """A real fetch of ``peer``'s frame by ``t``'s own wire half, its wire
    span scripted (1 ms) so the scoreboards are a function of the script."""
    raw = t._wire_fetch(peer, None, step)
    return raw[:3] + (0.001,) + raw[4:]


def _exchange(t, vec, clock, step):
    merged, alpha, partner = t.exchange(_as_in(t, vec), clock, 0.0, step)
    return np.asarray(merged, np.float32).copy(), float(alpha)


def test_async_drain_draw_bit_equal_to_reference():
    for seed in (0, 3, 17):
        for step in (0, 1, 5, 999):
            for peer in (0, 1, 3, 7):
                assert async_drain_draw(seed, step, peer) == ref_drain_draw(seed, step, peer)


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_staleness_damping_exact_per_lag(kind):
    """α · 0.5 ** lag at lags 0..4, the port's α the reference's."""
    want = []
    for k in ("ref", kind):
        nodes = _group((k, "ref"), async_rounds={"enabled": True, "max_staleness": 4,
                                                 "staleness_damping": 0.5},
                       interpolation="constant", factor=0.3, **SCRIPTED)
        try:
            t, eng = nodes[0], nodes[0].async_engine
            vec = np.ones(64, np.float32)
            got = []
            for lag in range(5):
                clock = 10.0 * (lag + 1)
                eng.offer(1, _raw(t, 1, vec * 1.5, clock - lag))
                _out, merges = eng.exchange(_as_in(t, vec), clock, 0.0, int(clock))
                assert len(merges) == 1 and merges[0][::2] == (1, lag)
                got.append(merges[0][1])
            assert all(got[lag] == got[0] * 0.5 ** lag for lag in range(5))
            want.append(got)
        finally:
            _close(nodes)
    assert want[0] == want[1]


def test_staleness_damping_composes_with_trust_damping():
    nodes = _group(("port", "ref"), async_rounds={"enabled": True, "staleness_damping": 0.5},
                   interpolation="constant", factor=0.5, **SCRIPTED)
    try:
        t, eng = nodes[0], nodes[0].async_engine
        t.publish(torch.ones(16), 0.0, 0.0)
        consume = t._consume_fetch

        def with_trust(raw, step, device):
            got = consume(raw, step, device)
            t._pending_trust_scale = 0.8
            return got

        t._consume_fetch = with_trust
        res = eng._consume(_raw(t, 1, np.ones(16), 7.0), 10.0, 0.0, 10, 3, "cpu")
        assert res is not None
        assert res[1] == float(np.float32(0.5) * np.float32(0.8)) * 0.5 ** 3
    finally:
        _close(nodes)


def test_drop_past_max_staleness_recorded_stale_as_the_reference():
    """Lag == max_staleness merges (maximally damped); lag == max + 1 drops
    as the soft ``stale`` outcome: the overflow bucket, the scoreboard's
    record, never a quarantine; both packages alike."""
    out = {}
    for kind in ("ref", "port"):
        nodes = _group((kind, "ref"), async_rounds={"enabled": True, "max_staleness": 4},
                       **SCRIPTED)
        try:
            t, eng = nodes[0], nodes[0].async_engine
            vec = np.ones(32, np.float32)
            eng.offer(1, _raw(t, 1, vec * 2.0, 6.0))
            m1, a1 = _exchange(t, vec, 10.0, 10)
            eng.offer(1, _raw(t, 1, vec * 2.0, 7.0))
            m2, a2 = _exchange(t, vec, 12.0, 12)
            snap = eng.snapshot()
            out[kind] = (m1.tobytes(), a1, m2.tobytes(), a2, snap["merges"], snap["stale_drops"],
                         snap["staleness_hist"], snap["peers"][1]["stale"], eng.pop_round_stale(),
                         t.scoreboard.snapshot()["peers"][1]["state"])
            assert a1 != 0.0 and a2 == 0.0 and m2.tobytes() == vec.tobytes()
            assert t.scoreboard.state(1) != PeerState.QUARANTINED
        finally:
            _close(nodes)
    assert out["port"] == out["ref"]
    assert out["port"][4:9] == (1, 1, [0, 0, 0, 0, 1, 1], 1, [1])


def test_dedup_guard_latches_only_after_the_screens_pass():
    """A poisoned frame does not latch its clock (a clean re-delivery of it
    merges); a second delivery of a merged clock, or an older one, is
    dropped as ``stale`` before landing; both packages alike."""
    out = {}
    for kind in ("ref", "port"):
        nodes = _group((kind, "ref"), async_rounds={"enabled": True}, **SCRIPTED)
        try:
            t = nodes[0]
            t.publish(_as_in(t, np.ones(16, np.float32)), 0.0, 0.0)
            consume = (lambda raw, step: t._consume_fetch(raw, step)) if _is_ref(t) else \
                (lambda raw, step: t._consume_fetch(raw, step, "cpu"))
            bad = np.ones(16, np.float32)
            bad[3] = np.nan
            seq = []
            for vec, clock in ((bad, 5.0), (np.ones(16), 5.0), (np.ones(16) * 2, 5.0),
                               (np.ones(16), 4.0), (np.ones(16), 6.0)):
                got = consume(_raw(t, 1, vec, clock), len(seq))
                seq.append((got is not None, t.last_fetch["outcome"], dict(t._async_guard)))
            out[kind] = seq
        finally:
            _close(nodes)
    assert out["port"] == out["ref"]
    assert [s[1] for s in out["port"]] == [Outcome.POISONED, Outcome.SUCCESS, Outcome.STALE,
                                           Outcome.STALE, Outcome.SUCCESS]
    assert out["port"][-1][2] == {1: 6.0}


def test_queued_duplicate_charged_stale_and_queue_sheds_oldest():
    out = {}
    for kind in ("ref", "port"):
        nodes = _group((kind, "ref"), async_rounds={"enabled": True, "queue_depth": 2},
                       **SCRIPTED)
        try:
            t, eng = nodes[0], nodes[0].async_engine
            vec = np.ones(16, np.float32)
            eng.offer(1, _raw(t, 1, vec * 2.0, 3.0))
            m1 = _exchange(t, vec, 3.0, 3)
            eng.offer(1, _raw(t, 1, vec * 2.0, 3.0))  # the same clock again: a duplicate
            for ck in (4.0, 6.0, 5.0):  # three into a queue of two: clock 4 shed
                eng.offer(1, _raw(t, 1, vec * ck, ck))
            m2 = _exchange(t, vec, 6.0, 6)
            snap = eng.snapshot()
            out[kind] = (m1[0].tobytes(), m2[0].tobytes(), snap["dup_drops"], snap["shed"],
                         snap["merges"], snap["peers"][1]["shed"],
                         t.scoreboard.snapshot()["peers"][1]["state"])
        finally:
            _close(nodes)
    assert out["port"] == out["ref"]
    # Clock 6 merges first (lag 0), then clock 5 meets the guard: stale.
    assert out["port"][2:5] == (1, 1, 2)


def test_async_shard_merge_on_its_slice_only():
    """A shard frame drained async (lag 0) merges its slice only, bit-equal
    to the lock-step shard exchange and to the reference's async drain."""
    rng = np.random.default_rng(7)
    v0 = rng.standard_normal(101).astype(np.float32)
    v1 = rng.standard_normal(101).astype(np.float32)
    out = {}
    for kind, extra in (("sync", {}), ("ref", dict(async_rounds={"enabled": True}, **SCRIPTED)),
                        ("port", dict(async_rounds={"enabled": True}, **SCRIPTED))):
        nodes = _group(("ref" if kind == "ref" else "port", "ref"), shard={"k": 2}, **extra)
        try:
            t = nodes[0]
            nodes[1].publish(v1, 1.0, 0.0)
            t.publish(_as_in(t, v0), 1.0, 0.0)
            if kind != "sync":
                t.async_engine.offer(1, _fetched(t, 1, 0))
            merged, alpha = _exchange(t, v0, 1.0, 0)
            out[kind] = (merged.tobytes(), alpha)
        finally:
            _close(nodes)
    assert out["port"] == out["ref"] == out["sync"]
    merged = np.frombuffer(out["port"][0], np.float32)
    assert np.any(merged == v0) and not np.array_equal(merged, v0)


def test_async_off_is_byte_identical_to_lock_step():
    rng = np.random.default_rng(11)
    base = [rng.standard_normal(48).astype(np.float32) for _ in range(2)]

    def drive(**kw):
        nodes = _group(("port", "ref"), **kw)
        try:
            assert nodes[0].async_engine is None and nodes[0]._async_guard is None
            vecs = [b.copy() for b in base]
            outs = []
            for it in range(4):
                for i, t in enumerate(nodes):
                    t.publish(_as_in(t, vecs[i]), float(it), 0.0)
                for i, t in enumerate(nodes):
                    vecs[i], _a = _exchange(t, vecs[i], float(it), it)
                outs.append([v.tobytes() for v in vecs])
            assert "async" not in nodes[0].health_snapshot()
            return outs
        finally:
            _close(nodes)

    assert drive() == drive(async_rounds={"enabled": False})


def _scripted_soak(kinds, rounds=12, d=64):
    """Four nodes, each with an engine on a VirtualClock; every round each
    publishes its replica, fetches its peers' frames through its own wire
    half and the script offers them: node i+1's five rounds late (dropped
    stale), the others' together every third round (a fold) and else 0-3
    rounds late, some twice (a duplicate), four at once into a queue of
    three (a shed), some never; then each exchanges.  Returns the replicas, the merges, the snapshots'
    counts and the scoreboards, all functions of the script."""
    reset_device_stats()
    nodes = _group(kinds, async_rounds={"enabled": True, "max_staleness": 4,
                                        "staleness_damping": 0.5, "queue_depth": 3}, **SCRIPTED)
    try:
        clocks = []
        for t in nodes:
            vc = RefClock() if _is_ref(t) else VirtualClock()
            (RefEngine if _is_ref(t) else AsyncExchangeEngine)(t, now=vc)
            clocks.append(vc)
        rng = np.random.default_rng(3)
        vecs = [rng.standard_normal(d).astype(np.float32) for _ in nodes]
        due = [[] for _ in nodes]  # (offer round, peer, raw)
        merges_log = []
        n = len(nodes)
        for r in range(rounds):
            for i, t in enumerate(nodes):
                t.publish(_as_in(t, vecs[i]), float(r), 0.0)
            for i, t in enumerate(nodes):
                for j in range(n):
                    if j == i:
                        continue
                    if j == (i + 1) % n:
                        delay = 5  # a straggler's frames: always past max_staleness
                    elif r % 3 == 0:
                        delay = 0  # fresh frames from the other peers together: a fold
                    elif (r + i + j) % 4 == 0:
                        continue  # a fetch that never came
                    else:
                        delay = (i + j + r) % 4
                    copies = 4 if r == 4 and j == (i + 2) % n else 1  # a full queue sheds
                    copies += (i + j + r) % 5 == 0  # a duplicate delivery
                    for c in range(copies):
                        due[i].append((r + delay + (c == 1 and copies == 2), j, _fetched(t, j, r)))
            for i, t in enumerate(nodes):
                for item in [x for x in due[i] if x[0] == r]:
                    clocks[i].advance(0.001)
                    t.async_engine.offer(item[1], item[2], step=r)
                due[i] = [x for x in due[i] if x[0] != r]
                clocks[i].advance(0.005)
                if _is_ref(t):
                    import jax.numpy as jnp

                    out, merges = t.async_engine.exchange_on_device(jnp.asarray(vecs[i]),
                                                                    float(r), 0.0, r)
                else:
                    out, merges = t.async_engine.exchange_on_device(torch.from_numpy(vecs[i]),
                                                                    float(r), 0.0, r)
                vecs[i] = np.asarray(out, np.float32).copy()
                merges_log.append((r, i, [(p, float(a), lag) for p, a, lag in merges]))
        keys = ("rounds", "merges", "stale_drops", "dup_drops", "shed", "fold_dispatches",
                "fold_frames", "staleness_hist", "pending_wait_s")
        snaps = [{k: t.async_engine.snapshot()[k] for k in keys} for t in nodes]
        boards = [t.scoreboard.snapshot() for t in nodes]
        for t in nodes:
            if not _is_ref(t):
                t.async_engine.release()
        return [v.tobytes() for v in vecs], merges_log, snaps, boards
    finally:
        _close(nodes)


def test_scripted_soak_of_a_mixed_group_equals_reference_and_reruns_bit_identical():
    """A 4-node soak, ref/port/port/ref, under virtual clocks: the replicas,
    every merge (peer, damped α, lag), the snapshots' merges, stale drops,
    duplicates, shed frames, folds and fold frames, and the scoreboards are
    an all-reference soak's (the reference's device drain); a rerun is bit
    for bit the same; and every lease is back in the ring."""
    want = _scripted_soak(("ref",) * 4)
    got = _scripted_soak(("ref", "port", "port", "ref"))
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert got[3] == want[3]
    again = _scripted_soak(("port",) * 4)
    assert again == _scripted_soak(("port",) * 4)
    assert again[:3] == want[:3]
    totals = {k: sum(s[k] for s in got[2]) for k in got[2][0] if k != "staleness_hist"}
    assert totals["merges"] > 0 and totals["stale_drops"] > 0 and totals["dup_drops"] > 0
    assert totals["fold_dispatches"] > 0 and totals["shed"] > 0


def test_engine_holds_and_gives_back_the_receive_ring():
    """Queued frames hold their leases (the snapshot's held bytes and its
    peak); a shed or stale-dropped frame and a close give them back."""
    nodes = _group(("port", "port"), async_rounds={"enabled": True, "queue_depth": 1},
                   **SCRIPTED)
    t, eng = nodes[0], nodes[0].async_engine
    try:
        v = np.ones(5000, np.float32)
        nodes[1].publish(torch.from_numpy(v), 3.0, 0.0)
        t.publish(torch.from_numpy(v), 3.0, 0.0)
        for _ in range(3):
            eng.offer(1, _fetched(t, 1, 0))
        assert eng.snapshot()["held_bytes"] == 3 * 20000
        eng._collect(3.0)  # a queue of one: two shed
        assert eng.snapshot()["held_bytes"] == 20000 and eng.snapshot()["shed"] == 2
        assert eng.snapshot()["peak_held_bytes"] == 3 * 20000
        eng.offer(1, _fetched(t, 1, 0))
    finally:
        _close(nodes)
    assert eng.snapshot()["held_bytes"] == 0
    gc.collect()
    assert t.ring.stats()["leased_bytes"] == 0
