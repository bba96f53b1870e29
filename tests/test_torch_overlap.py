"""The overlapped exchange and the prefetch pipeline of the port's TCP
transport, held to the reference.

Mirrors ``tests/test_tcp_transport.py:400-580`` (the overlapped exchange's
algebra, its skip and its join backstop) and ``tests/test_prefetch.py``
(the double-buffered pipeline: merges, the overlap tally, top-k, a dead
partner, the flag off).  Those reference tests bind fixed ports and can
collide in a parallel run; here every socket binds port 0 and is wired
with ``set_peer_port``.  A group of reference and port nodes runs lock-step
on one thread, each node's prefetch slot joined right after its exchange,
so each fetch lands at the same point of the script in both groups.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.device import reset_device_stats
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.parallel import tcp

BASE = dict(schedule="ring", interpolation="clock", factor=0.7, timeout_ms=2000, seed=6,
            trust={"window": 16, "min_window": 4})


def _ephemeral(cfg):
    return dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))


def _group(kinds, **kw):
    """Nodes of ``kinds`` ("ref" / "port") under one config, flowctl off."""
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


def _join_slot(t):
    """Wait for a node's prefetch slot to finish streaming."""
    slot = t._prefetch_slot
    if slot is None:
        return
    th = slot["thread"] if "thread" in slot else getattr(slot["slot"], "thread", None)
    if th is not None:
        th.join(10.0)


def _as_in(kind, v):
    return v.copy() if kind == "ref" else torch.from_numpy(v.copy())


def _run_ring(kinds, rounds=12, d=1000, dead_after=None, **kw):
    """Lock-step rounds: every node publishes, then each exchanges and its
    slot is joined.  ``dead_after``: node1 closed after that many rounds
    (node0 alone exchanges on).  Returns each exchange's decisions, α and
    merged bytes, and each node's overlap tally (None with the flag off)."""
    reset_device_stats()
    nodes = _group(kinds, **kw)
    target = np.linspace(-1.0, 1.0, d).astype(np.float32)
    rng = np.random.default_rng(4)
    vecs = [(target + rng.standard_normal(d)).astype(np.float32) for _ in kinds]
    log = []
    try:
        for r in range(rounds):
            live = range(len(kinds)) if dead_after is None or r < dead_after else [0]
            if dead_after is not None and r == dead_after:
                nodes[1].close()
            vecs = [(v - 0.2 * (v - target) / d).astype(np.float32) for v in vecs]
            for i in live:
                nodes[i].publish(_as_in(kinds[i], vecs[i]), r + 1.0 + i, 0.5)
            for i in live:
                t = nodes[i]
                merged, alpha, partner = t.exchange(_as_in(kinds[i], vecs[i]), r + 1.0 + i, 0.5, r)
                _join_slot(t)
                vecs[i] = np.asarray(merged, np.float32).copy()
                lr = t.last_round
                log.append((r, i, lr["sched_partner"], lr["partner"], lr["remapped"],
                            lr["outcome"], partner, float(alpha), lr.get("codec"),
                            lr.get("trust", {}).get("verdict"), vecs[i].tobytes()))
        tallies = []
        for t in nodes[:1] if dead_after is not None else nodes:
            ov = t.wire_snapshot().get("overlap")
            tallies.append(None if ov is None else (ov["rounds"], ov["prefetched"]))
        return log, tallies
    finally:
        _close(nodes)


@pytest.mark.parametrize("case", [
    ("ref", "port"), ("ref", "port", "port", "ref"),
    ("ref", "port", "topk"), ("ref", "port", "port", "ref", "topk"),
    ("ref", "port", "chaos"),
])
def test_prefetch_group_equals_reference(case):
    """A 2-node and a 4-node ring with ``overlap_prefetch`` on f32 and on
    topk 0.05, 12 rounds: every round's (sched_partner, partner, remapped,
    outcome), α, verdict and merged replica, and the overlap tally's rounds
    and prefetched, equal an all-reference ring's.  With chaos, node1's
    link to node0 is cut for its publish clocks 4 and 5: the slot launched
    at clock 3 streams and the consuming round (clock 4) refuses its frame;
    the slots launched at clocks 4 and 5 are refused at their launch."""
    kinds = tuple(k for k in case if k in ("ref", "port"))
    kw = dict(overlap_prefetch=True)
    if "topk" in case:
        kw.update(wire_codec="topk", topk_fraction=0.05)
    if "chaos" in case:
        kw.update(chaos={"enabled": True, "link_windows": [[1, 0, 4, 6]]})
    want, want_tally = _run_ring(("ref",) * len(kinds), **kw)
    got, got_tally = _run_ring(kinds, **kw)
    for g, w in zip(got, want):
        assert g[:10] == w[:10], (g[:10], w[:10])
        assert g == w, g[:2]
    assert got_tally == want_tally
    assert got_tally[0] == (12, 11)  # every round but the cold first from a slot
    assert sum(1 for g in got if g[7] != 0.0) >= 12
    refused = [(g[0], g[1]) for g in got if g[5] == Outcome.REFUSED]
    assert refused == ([(2, 1), (3, 1), (4, 1)] if "chaos" in case else [])


def test_prefetch_dead_partner_equals_reference():
    """Node1 closes after 3 rounds: the frame its slot streamed before still
    merges, every later fetch is refused, and node0's decisions and replica
    are an all-reference pair's."""
    kw = dict(overlap_prefetch=True, timeout_ms=300, health={"enabled": False})
    want, want_tally = _run_ring(("ref", "ref"), rounds=7, dead_after=3, **kw)
    got, got_tally = _run_ring(("port", "ref"), rounds=7, dead_after=3, **kw)
    assert got == want and got_tally == want_tally == [(7, 6)]
    assert [g[5] for g in got[-2:]] == [Outcome.REFUSED, Outcome.REFUSED]
    assert [g[7] for g in got[-2:]] == [0.0, 0.0]


def test_prefetch_off_equals_reference_lock_step_and_keeps_no_state():
    want, want_tally = _run_ring(("ref", "ref", "ref", "ref"), rounds=6)
    got, got_tally = _run_ring(("ref", "port", "port", "ref"), rounds=6)
    assert got == want and got_tally == want_tally == [None] * 4
    nodes = _group(("port", "port"))
    try:
        nodes[1].publish(np.ones(16, np.float32), 1.0, 0.5)
        nodes[0].exchange(np.zeros(16, np.float32), 1.0, 0.5, 0)
        assert not nodes[0]._prefetch_on and nodes[0]._prefetch_slot is None
        assert "wire" not in nodes[0].health_snapshot()
        assert "overlap" not in nodes[0].wire_snapshot()
    finally:
        _close(nodes)


@pytest.mark.parametrize("case", ["merged", "skipped", "int8"])
def test_overlapped_finish_bit_equal_to_reference(case):
    """``exchange_overlapped_start(...).finish(pre, update)``: on a merged
    round ``merge(pre, remote) + update`` and on a skipped one (the partner
    never published) ``pre + update`` with α 0, bit-equal to the
    reference's, a port node fetching from a reference one and back."""
    d = 257
    pre = [np.arange(d, dtype=np.float32) * 0.01, np.arange(d, dtype=np.float32)[::-1] * 0.02]
    update = np.full(d, 0.25, np.float32)
    kw = dict(wire_dtype="int8") if case == "int8" else {}
    if case == "skipped":
        kw["timeout_ms"] = 200
    results = {}
    for kinds in (("ref", "ref"), ("port", "ref"), ("ref", "port")):
        nodes = _group(kinds, **kw)
        try:
            if case != "skipped":
                nodes[1].publish(_as_in(kinds[1], pre[1]), 3.0, 0.5)
            ex = nodes[0].exchange_overlapped_start(_as_in(kinds[0], pre[0]), 1.0, 0.5, 0)
            merged, alpha, partner = ex.finish(pre[0].copy(), update)
            results[kinds] = (np.asarray(merged, np.float32).tobytes(), float(alpha), partner)
            bare = nodes[0].exchange_overlapped_start(_as_in(kinds[0], pre[0]), 2.0, 0.5, 1)
            got = bare.finish(pre[0])
            if got[1] == 0.0:
                assert got[0] is pre[0]  # nothing merged, no update: pre itself
        finally:
            _close(nodes)
    assert results[("port", "ref")] == results[("ref", "ref")]
    assert results[("ref", "port")] == results[("ref", "ref")]
    merged, alpha, partner = results[("ref", "ref")]
    assert partner == 1 and (alpha == 0.0) == (case == "skipped")
    if case == "skipped":
        assert merged == (pre[0] + update).tobytes()


WIRE_SETTINGS = [
    {}, dict(wire_dtype="bf16"), dict(wire_dtype="int8"),
    dict(wire_codec="topk", topk_fraction=0.05),
    dict(wire_codec="topk", topk_fraction=0.1, topk_values="f32"),
    dict(shard={"k": 4}), dict(shard={"k": 3}, wire_dtype="int8"),
    dict(shard={"k": 4}, wire_codec="topk"),
]


def test_join_backstop_and_wire_nbytes_follow_the_reference():
    """The join waits ``1 + base + nbytes / rate`` (base doubled from the
    larger of ``timeout_ms`` and ``flowctl.max_ms`` under flowctl), sized by
    the frame as published: every codec's bytes the reference's."""
    for kw in WIRE_SETTINGS:
        ref_t = ref_tcp.TcpTransport(_ephemeral(ref_config(2, base_port=0, **kw)), "node0")
        port_t = tcp.TcpTransport(_ephemeral(make_local_config(2, **kw)), "node0", device="cpu")
        try:
            for n in (1000, 4099):
                assert port_t._wire_nbytes(n) == ref_t._wire_nbytes(np.zeros(n, np.float32)), kw
        finally:
            ref_t.close()
            port_t.close()
    for flowctl in ({"enabled": False}, {}):
        cfg = make_local_config(2, timeout_ms=700, min_wire_mb_per_s=5.0, flowctl=flowctl)
        t = tcp.TcpTransport(_ephemeral(cfg), "node0", device="cpu")
        try:
            fc = cfg.flowctl
            base = 0.7 if not fc.enabled else 2.0 * max(0.7, fc.max_ms / 1000.0)
            assert t._join_backstop_s(10_000_000) == 1.0 + base + 10_000_000 / 5e6
        finally:
            t.close()


def test_consume_judges_against_the_replica_published_in_the_consuming_round():
    """A frame fetched before a publish and consumed after it (a straddled
    prefetch) is read against the newer replica: a top-k frame densifies
    against it, and off its support equals it."""
    nodes = _group(("port", "port"), wire_codec="topk", topk_fraction=0.1)
    try:
        d = 500
        a = np.linspace(0.0, 1.0, d).astype(np.float32)
        nodes[1].publish(torch.from_numpy(a[::-1].copy()), 2.0, 0.5)
        nodes[0].publish(torch.from_numpy(a), 1.0, 0.5)
        raw = nodes[0]._wire_fetch(1, None, 0)
        newer = torch.from_numpy(a * 3.0)
        nodes[0].publish(newer, 2.0, 0.5)
        landed, _clock, _loss = nodes[0]._consume_fetch(raw, 0, "cpu")
        off = torch.ones(d, dtype=torch.bool)
        off[landed.merge.indices] = False
        assert torch.equal(landed.dense[off], newer[off])
        assert nodes[0].last_fetch["outcome"] == Outcome.SUCCESS
    finally:
        _close(nodes)


def test_pipeline_gives_every_lease_back():
    """A slot launched for a round that never comes (a step that does not
    follow) is abandoned, and every lease is back in the receive ring once
    the frames are gone and the transport is closed."""
    nodes = _group(("port", "port"), overlap_prefetch=True)
    try:
        v = np.linspace(0.0, 1.0, 3000).astype(np.float32)
        for i, t in enumerate(nodes):
            t.publish(v * (i + 1), 1.0, 0.5)
        nodes[0].exchange(v, 1.0, 0.5, 0)
        _join_slot(nodes[0])
        assert nodes[0].ring.stats()["leased_bytes"] > 0  # round 1's frame, streamed
        nodes[0].exchange(v, 2.0, 0.5, 5)  # not round 1: fetched here, synchronously
        _join_slot(nodes[0])
        ov = nodes[0].wire_snapshot()["overlap"]
        assert (ov["rounds"], ov["prefetched"]) == (2, 0)
    finally:
        _close(nodes)
    gc.collect()
    assert nodes[0].ring.stats()["leased_bytes"] == 0
