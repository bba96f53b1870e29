"""The port's recovery plane against the reference's, on the CPU over
localhost sockets.

- ``pack_state`` byte-equal to the reference's for the same leaves and
  meta (vectors, 0-d leaves, a dict of tensors against the reference's dict
  of arrays), each package unpacking the other's blob, and the reference's
  corruption cases (``tests/test_recovery.py``) refused by both.
- ``RollbackRing``: the newest snapshot first, then deeper, copies of what
  was pushed; the same (step, vector) sequence as the reference's ring over
  seeded push/rollback sequences.
- The STATE wire between the packages, both ways and port to port:
  chunked transfers, a transfer resumed after short reads, a CRC mismatch
  giving ``corrupt``, no state giving an empty success, and a state packed
  lazily once per publish.
- The guard's verdicts and the donor election equal to the reference's.
- Adapters, a ``dpwa_tpu_torch`` node beside a ``dpwa_tpu`` node against a
  pair of ``dpwa_tpu`` nodes: a NaN replica at round 3 rolled back, the
  frame carrying the snapshot's loss, the partner recording ``success`` and
  every merge bit-equal; a rejoiner of either package bootstrapping from a
  donor of the other, landing on its step, clock and vector; a poisoned
  donor refused; the re-sync advice when a probed peer's clock leads by
  more than ``max_clock_lag``, and ``auto_resync`` adopting the donor's
  vector and clock while keeping the step.  The state a port node serves
  is the bytes the reference node would serve.

Every socket binds port 0 and peers are wired with ``set_peer_port``.
"""

import dataclasses
import socket
import threading
import zlib

import jax
import numpy as np
import pytest
import torch

from dpwa_tpu.adapters.tcp_adapter import DpwaTcpAdapter as RefAdapter
from dpwa_tpu.config import RecoveryConfig as RefRecoveryConfig
from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.parallel import protocol_constants as ref_pc
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu.recovery import RollbackRing as RefRing
from dpwa_tpu.recovery import bootstrap as ref_bootstrap
from dpwa_tpu.recovery import guard as ref_guard
from dpwa_tpu.recovery import state_transfer as ref_st
from dpwa_tpu_torch.adapters import DpwaTcpAdapter
from dpwa_tpu_torch.config import RecoveryConfig, make_local_config
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel import tcp
from dpwa_tpu_torch.recovery import (
    RollbackRing,
    bootstrap_from_peer,
    choose_donor,
    pack_state,
    unpack_state,
    validate_payload,
)

UNPORTED_OFF = ("membership", "trust", "flowctl")
REF_UNPORTED_OFF = {p: {"enabled": False} for p in UNPORTED_OFF}


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


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# -- the packed state ----------------------------------------------------------

def _leaves_case(name):
    rng = np.random.default_rng(len(name))
    v = rng.standard_normal(1001).astype(np.float32)
    v[:3] = [np.nan, -0.0, np.inf]
    if name == "vector":
        return [v], [torch.from_numpy(v.copy())], {"kind": "tcp_adapter", "clock": 7.0,
                                                    "step": 6, "loss": 0.25}
    if name == "scalars":
        leaves = [np.float64(3.25), np.int32(7), np.arange(12, dtype=np.float32).reshape(3, 4)]
        return leaves, list(leaves), {"step": 5, "clock": 2.0}
    if name == "python_numbers":
        return [1.5, 3], [1.5, 3], None
    if name == "dict":
        tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
                "b": np.zeros(4, np.float64), "a": np.arange(5, dtype=np.int64)}
        return tree, {k: torch.from_numpy(x.copy()) for k, x in tree.items()}, {"peer": 3}
    if name == "empty":
        return [], [], {}
    raise KeyError(name)


PACK_CASES = ["vector", "scalars", "python_numbers", "dict", "empty"]


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_state_byte_equal_to_reference(case):
    ref_tree, tree, meta = _leaves_case(case)
    assert pack_state(tree, meta=meta) == ref_st.pack_state(ref_tree, meta=meta)


@pytest.mark.parametrize("case", PACK_CASES)
def test_each_package_unpacks_the_others_blob(case):
    ref_tree, tree, meta = _leaves_case(case)
    ref_leaves = jax.tree_util.tree_leaves(ref_tree) if isinstance(ref_tree, dict) else ref_tree
    for blob in (pack_state(tree, meta=meta), ref_st.pack_state(ref_tree, meta=meta)):
        mine, my_meta = unpack_state(blob)
        theirs, their_meta = ref_st.unpack_state(blob)
        assert my_meta == their_meta == (meta or {})
        assert len(mine) == len(theirs) == len(ref_leaves)
        for a, b, want in zip(mine, theirs, ref_leaves):
            want = np.asarray(want)
            assert a.dtype == b.dtype == want.dtype and a.shape == b.shape == want.shape
            assert a.tobytes() == b.tobytes() == want.tobytes()
    if case == "dict":
        got, _ = unpack_state(ref_st.pack_state(ref_tree, meta=meta), like=tree)
        assert list(got) == list(tree)
        for k in tree:
            assert isinstance(got[k], torch.Tensor) and torch.equal(got[k], tree[k])


CORRUPTIONS = {
    "payload_byte": (lambda b: b[:-1] + bytes([b[-1] ^ 0xFF]), "CRC"),
    "magic": (lambda b: b"XXXX" + b[4:], "magic"),
    "truncated": (lambda b: b[:-3], "CRC|truncated|trailing|length"),
    "too_short": (lambda b: b[:5], "short"),
    "header_length": (lambda b: b[:4] + pc.STATE_PACK_LEN.pack(1 << 30) + b[8:], "length"),
    "header_json": (lambda b: b[:8] + b"!" + b[9:], "JSON"),
}


@pytest.mark.parametrize("case", list(CORRUPTIONS))
def test_unpack_refuses_corruption_as_reference(case):
    tree = [np.ones(8, np.float32)]
    blob = pack_state([torch.ones(8)])
    assert blob == ref_st.pack_state(tree)
    mutate, match = CORRUPTIONS[case]
    bad = mutate(blob)
    with pytest.raises(ValueError, match=match):
        unpack_state(bad)
    with pytest.raises(ValueError, match=match):
        ref_st.unpack_state(bad)


def test_unpack_refuses_the_wrong_template():
    blob = pack_state([torch.ones(8)])
    with pytest.raises(ValueError, match="shape"):
        unpack_state(blob, like=[torch.zeros(2, 4)])
    with pytest.raises(ValueError, match="leaves"):
        unpack_state(blob, like=[torch.zeros(8)] * 2)


def test_protocol_state_constants_equal_reference():
    for name in ("STATE_REQ", "STATE_MAGIC", "STATE_PACK_MAGIC", "MAX_STATE_CHUNK_BYTES",
                 "MAX_BLOB_BYTES"):
        assert getattr(pc, name) == getattr(ref_pc, name), name
    for name in ("STATE_REQ_BODY", "STATE_HDR", "STATE_PACK_LEN"):
        assert getattr(pc, name).format == getattr(ref_pc, name).format, name


# -- the rollback ring --------------------------------------------------------

def test_rollback_ring_pops_newest_then_digs_deeper():
    ring = RollbackRing(3)
    vecs = [torch.full((4,), float(i)) for i in range(5)]
    for i, v in enumerate(vecs):
        ring.push(v, step=i, clock=float(i), loss=0.1 * i)
        v += 100.0  # the caller's buffer moves on: the ring holds copies
    assert len(ring) == 3 and ring.newest().step == 4 and len(ring) == 3
    for want in (4, 3, 2):
        snap = ring.rollback()
        assert snap.step == want and snap.clock == float(want)
        assert torch.equal(snap.vec, torch.full((4,), float(want)))
    assert ring.rollback() is None and ring.newest() is None
    assert (ring.pushes, ring.rollbacks) == (5, 3)
    with pytest.raises(ValueError):
        RollbackRing(0)
    with pytest.raises(ValueError):
        ring.push(torch.zeros(5), 0, 0.0, 0.0)


@pytest.mark.parametrize("seed", range(5))
def test_rollback_ring_replays_as_reference(seed):
    rng = np.random.default_rng(seed)
    capacity = int(rng.integers(1, 5))
    mine, ref = RollbackRing(capacity), RefRing(capacity)
    got, want = [], []
    for i in range(40):
        if rng.random() < 0.35:
            a, b = mine.rollback(), ref.rollback()
            got.append(None if a is None else (a.step, a.clock, a.loss, a.vec.numpy().tobytes()))
            want.append(None if b is None else (b.step, b.clock, b.loss, b.vec.tobytes()))
        else:
            v = rng.standard_normal(7).astype(np.float32)
            mine.push(torch.from_numpy(v.copy()), i, i + 0.5, -i)
            ref.push(v, i, i + 0.5, -i)
        assert len(mine) == len(ref)
    assert got == want and (mine.pushes, mine.rollbacks) == (ref.pushes, ref.rollbacks)


# -- the STATE wire -----------------------------------------------------------

def _server(kind):
    return tcp.PeerServer("127.0.0.1", 0) if kind == "port" else ref_tcp.PeerServer("127.0.0.1", 0)


def _fetcher(kind):
    return (tcp.fetch_state, tcp.fetch_state_chunk) if kind == "port" else (
        ref_tcp.fetch_state, ref_tcp.fetch_state_chunk)


WAYS = [("port", "ref"), ("ref", "port"), ("port", "port")]  # (server, fetcher)


@pytest.mark.parametrize("server_kind,fetch_kind", WAYS)
def test_state_transfer_chunked_between_packages(server_kind, fetch_kind):
    srv = _server(server_kind)
    fetch_state, _ = _fetcher(fetch_kind)
    try:
        blob = ref_st.pack_state([np.arange(9001, dtype=np.float32)], meta={"step": 3})
        srv.publish_state(blob)
        got, outcome, _lat, nrx = fetch_state("127.0.0.1", srv.port, timeout_ms=2000,
                                              chunk_bytes=1024)
        assert outcome == Outcome.SUCCESS and got == blob and nrx == len(blob)
        state, meta = unpack_state(got)
        assert meta == {"step": 3} and np.array_equal(state[0], np.arange(9001, dtype=np.float32))
        # A new publish: a new generation, the whole new state.
        blob2 = pack_state([torch.zeros(10)], meta={"step": 4})
        srv.publish_state(blob2)
        assert fetch_state("127.0.0.1", srv.port, timeout_ms=2000, chunk_bytes=7)[0] == blob2
    finally:
        srv.close()


@pytest.mark.parametrize("server_kind,fetch_kind", WAYS)
def test_no_published_state_is_an_empty_success(server_kind, fetch_kind):
    srv = _server(server_kind)
    fetch_state, fetch_chunk = _fetcher(fetch_kind)
    try:
        got, outcome, _lat, _nrx = fetch_state("127.0.0.1", srv.port, timeout_ms=1000)
        assert outcome == Outcome.SUCCESS and got == b""
        chunk, outcome, _lat, _nrx = fetch_chunk("127.0.0.1", srv.port, 0, 1 << 20, 1000)
        assert outcome == Outcome.SUCCESS and bytes(chunk[0]) == b"" and chunk[1:] == (0, 0)
    finally:
        srv.close()
    refused = _closed_port()
    assert fetch_state("127.0.0.1", refused, timeout_ms=300)[:2] == (None, Outcome.REFUSED)


class _Flaky:
    """A proxy in front of ``upstream`` that hard-closes the first
    ``fails`` connections after a partial STATE header."""

    def __init__(self, upstream, fails):
        self.fails = fails
        self.upstream = upstream
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self._sock.settimeout(0.1)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                continue
            conn.settimeout(2.0)
            with conn:
                try:
                    req = conn.recv(len(pc.STATE_REQ) + pc.STATE_REQ_BODY.size)
                    if self.fails > 0:
                        self.fails -= 1
                        conn.sendall(pc.STATE_MAGIC)
                        continue
                    with socket.create_connection(("127.0.0.1", self.upstream), timeout=2.0) as up:
                        up.sendall(req)
                        while True:
                            b = up.recv(65536)
                            if not b:
                                break
                            conn.sendall(b)
                except OSError:
                    pass

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._sock.close()
        assert not self._thread.is_alive()


@pytest.mark.parametrize("server_kind,fetch_kind", WAYS)
def test_state_transfer_resumes_after_short_reads(server_kind, fetch_kind):
    srv = _server(server_kind)
    fetch_state, _ = _fetcher(fetch_kind)
    blob = pack_state([torch.arange(4096, dtype=torch.float32)])
    srv.publish_state(blob)
    proxy = _Flaky(srv.port, fails=3)
    try:
        got, outcome, _lat, _nrx = fetch_state("127.0.0.1", proxy.port, timeout_ms=1000,
                                               chunk_bytes=2048, max_retries=8)
        assert outcome == Outcome.SUCCESS and got == blob and proxy.fails == 0
        proxy.fails = 3
        got, outcome, _lat, _nrx = fetch_state("127.0.0.1", proxy.port, timeout_ms=1000,
                                               chunk_bytes=2048, max_retries=2)
        assert got is None and outcome == Outcome.SHORT_READ
    finally:
        proxy.close()
        srv.close()


@pytest.mark.parametrize("fetch_kind", ["port", "ref"])
def test_state_chunk_crc_mismatch_is_corrupt(fetch_kind):
    lsn = socket.socket()
    lsn.bind(("127.0.0.1", 0))
    lsn.listen(4)

    def evil():
        for _ in range(2):
            try:
                conn, _ = lsn.accept()
            except OSError:
                return
            with conn:
                try:
                    conn.recv(len(pc.STATE_REQ) + pc.STATE_REQ_BODY.size)
                    payload = b"\x00" * 64
                    conn.sendall(pc.STATE_HDR.pack(pc.STATE_MAGIC, 1, 0, 64, 0, 64,
                                                   zlib.crc32(payload) ^ 0xDEADBEEF) + payload)
                except OSError:
                    pass

    th = threading.Thread(target=evil, daemon=True)
    th.start()
    fetch_state, fetch_chunk = _fetcher(fetch_kind)
    try:
        got, outcome, _lat, nrx = fetch_chunk("127.0.0.1", lsn.getsockname()[1], 0, 1 << 20, 1000)
        assert got is None and outcome == Outcome.CORRUPT and nrx == 64
        got, outcome, _lat, _n = fetch_state("127.0.0.1", lsn.getsockname()[1], 1000,
                                             max_retries=0)
        assert got is None and outcome == Outcome.CORRUPT
    finally:
        lsn.close()
        th.join(timeout=5.0)


def test_lazy_state_is_packed_once_per_publish():
    srv = tcp.PeerServer("127.0.0.1", 0)
    calls = []

    def pack():
        calls.append(1)
        return pack_state([torch.arange(3000, dtype=torch.float32)], meta={"n": len(calls)})

    try:
        srv.publish_state(pack)
        assert not calls  # nothing read until a peer asks
        blob, outcome, _lat, _n = tcp.fetch_state("127.0.0.1", srv.port, 2000, chunk_bytes=1000)
        assert outcome == "success" and len(calls) == 1 and unpack_state(blob)[1] == {"n": 1}
        assert ref_tcp.fetch_state("127.0.0.1", srv.port, 2000, chunk_bytes=999)[0] == blob
        assert len(calls) == 1
        srv.publish_state(pack)
        assert unpack_state(tcp.fetch_state("127.0.0.1", srv.port, 2000)[0])[1] == {"n": 2}
    finally:
        srv.close()


# -- the guard and the donor election -----------------------------------------

def test_validate_payload_classifies_as_reference():
    kw = dict(max_param_norm=10.0, max_loss=100.0)
    mine, ref = RecoveryConfig(**kw), RefRecoveryConfig(**kw)
    ok = np.ones(4, np.float32)
    cases = [
        (ok, 1.0, None), (np.array([1.0, np.nan], np.float32), 1.0, None),
        (ok * 1e6, 1.0, None), (ok, float("nan"), None), (ok, float("inf"), None),
        (ok, 1e9, None), (ok, -1e9, None), (ok * 1e-6, 1.0, 1.0), (ok, 1.0, 1.0),
        (np.zeros(4, np.float32), 0.0, 2.0),
    ]
    for vec, loss, local_norm in cases:
        want = ref_guard.validate_payload(vec, loss, ref, local_norm=local_norm)
        assert validate_payload(vec, loss, mine, local_norm=local_norm) == want
        assert validate_payload(torch.from_numpy(vec), loss, mine, local_norm=local_norm) == want


def test_choose_donor_equal_to_reference():
    rng = np.random.default_rng(3)
    for _ in range(60):
        n = int(rng.integers(2, 9))
        me, step, seed = int(rng.integers(n)), int(rng.integers(1000)), int(rng.integers(99))
        healthy = [bool(h) for h in rng.random(n) < 0.7]
        exclude = tuple(int(p) for p in rng.choice(n, size=int(rng.integers(0, 3))))
        assert choose_donor(me, n, step, seed, healthy, exclude) == ref_bootstrap.choose_donor(
            me, n, step, seed, healthy, exclude)


# -- adapters --------------------------------------------------------------------

def _configs(**kw):
    rec = kw.pop("recovery", None)
    return {
        "ref": _ephemeral(ref_config(2, base_port=0, recovery=rec, **kw, **REF_UNPORTED_OFF)),
        "port": _ephemeral(make_local_config(2, recovery=rec, disabled_planes=UNPORTED_OFF, **kw)),
    }


def _tree(i):
    rng = np.random.default_rng(40 + i)
    return {"w": rng.standard_normal(64).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32)}


def _adapter(kind, i, cfgs, **kw):
    tree = _tree(i)
    if kind == "ref":
        return RefAdapter(tree, f"node{i}", cfgs["ref"], **kw)
    return DpwaTcpAdapter({k: torch.from_numpy(v) for k, v in tree.items()}, f"node{i}",
                          cfgs["port"], device="cpu", **kw)


def _vec(a):
    return np.asarray(a._vec) if isinstance(a, RefAdapter) else a.vector().numpy()


def _params(a, vec):
    """``vec`` (the reference order) as the adapter's ``params``."""
    if isinstance(a, RefAdapter):
        return a._unravel(vec)
    saved = a.flat.flat[0].clone()
    a.flat.flat[0].index_copy_(0, a._order, torch.from_numpy(np.ascontiguousarray(vec)))
    out = {k: view[0].clone() for k, view in a.flat.views().items()}
    a.flat.flat[0].copy_(saved)
    return out


def _wire_adapters(adapters):
    for a in adapters:
        for i, other in enumerate(adapters):
            a.transport.set_peer_port(i, other.transport.port)


def _frame_loss(a):
    """The loss in the frame the adapter's server publishes now."""
    return pc.BLOB_HDR.unpack_from(a.transport.server._payload, 0)[4]


def _nan_run(kinds):
    cfgs = _configs(schedule="ring", interpolation="clock", factor=0.7,
                    recovery={"snapshot_ring": 3})
    adapters = [_adapter(k, i, cfgs) for i, k in enumerate(kinds)]
    log = []
    try:
        _wire_adapters(adapters)
        for r in range(7):
            losses = [0.5 + 0.1 * r, 0.7 - 0.05 * r]
            new = [_vec(a) * np.float32(0.9) + np.float32(0.01 * (r + 1)) for a in adapters]
            if r == 3:  # node 0's step diverged
                new[0] = np.full_like(new[0], np.nan)
                losses[0] = float("nan")
            params = [_params(a, v) for a, v in zip(adapters, new)]
            for a, v, l in zip(adapters, new, losses):  # lock-step: this round's frames first
                a.transport.publish(v if isinstance(a, RefAdapter) else torch.from_numpy(v),
                                    a._clock + 1.0, l)
            for a, p, l in zip(adapters, params, losses):
                a.update(l, params=p)
                log.append((r, a.transport.me, _frame_loss(a), a.last_alpha,
                            a.transport.last_round.get("outcome"), _vec(a).tobytes()))
            if r == 3:
                log.append(("rollback", dict(adapters[0].last_rollback)))
    finally:
        for a in adapters:
            a.close()
    return log


@pytest.mark.parametrize("kinds", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_local_nan_rolls_back_as_reference_pair(kinds):
    want = _nan_run(("ref", "ref"))
    got = _nan_run(kinds)
    assert got == want
    rollback = next(e[1] for e in want if e[0] == "rollback")
    assert rollback == {"step": 3, "reason": "nonfinite_params", "restored": True,
                        "snapshot_step": 2}
    # The partner merged the restored replica: every outcome a success, every
    # frame's loss finite.
    rounds = [e for e in want if e[0] != "rollback"]
    assert all(e[4] == "success" for e in rounds)
    assert all(np.isfinite(e[2]) for e in rounds)


def _bootstrap_run(donor_kind, rejoiner_kind, monkeypatch):
    cfgs = _configs(schedule="ring", interpolation="constant", factor=0.3)
    donor = _adapter(donor_kind, 0, cfgs)
    rejoiner = None
    try:
        donor.transport.set_peer_port(1, _closed_port())
        for r in range(4):
            donor.update(0.25 + r)
        if rejoiner_kind == "port":
            # A restarted port node: its transport wired first, then
            # DPWA_BOOTSTRAP=1 in the environment, as a supervisor sets it.
            t = tcp.TcpTransport(cfgs["port"], "node1", device="cpu")
            t.set_peer_port(0, donor.transport.port)
            monkeypatch.setenv("DPWA_BOOTSTRAP", "1")
            tree = _tree(1)
            rejoiner = DpwaTcpAdapter({k: torch.from_numpy(v) for k, v in tree.items()},
                                      "node1", cfgs["port"], transport=t)
            monkeypatch.delenv("DPWA_BOOTSTRAP")
        else:
            rejoiner = _adapter("ref", 1, cfgs, bootstrap=False)
            rejoiner.transport.set_peer_port(0, donor.transport.port)
            assert rejoiner._bootstrap_from_peer()
        info = rejoiner.last_bootstrap
        return (_vec(donor).tobytes(), _vec(rejoiner).tobytes(), donor.step, rejoiner.step,
                donor._clock, rejoiner._clock, info["donor"], info["attempts"],
                info["meta"], info["nbytes"])
    finally:
        donor.close()
        if rejoiner is not None:
            rejoiner.close()


@pytest.mark.parametrize("donor_kind,rejoiner_kind",
                         [("ref", "port"), ("port", "ref"), ("port", "port")])
def test_bootstrap_lands_as_reference_both_ways(donor_kind, rejoiner_kind, monkeypatch):
    want = _bootstrap_run("ref", "ref", monkeypatch)
    got = _bootstrap_run(donor_kind, rejoiner_kind, monkeypatch)
    assert got == want
    donor_vec, landed, donor_step, step, donor_clock, clock, donor, attempts, meta, nbytes = got
    assert landed == donor_vec and step == donor_step == 4 and clock == donor_clock == 4.0
    assert (donor, attempts) == (0, 1) and meta["kind"] == "tcp_adapter"
    assert nbytes > 72 * 4


def test_bootstrap_refuses_a_poisoned_donor():
    cfgs = _configs()
    donor = ref_tcp.PeerServer("127.0.0.1", 0)
    rejoiner = _adapter("port", 1, cfgs, bootstrap=False)
    try:
        donor.publish(np.ones(72, np.float32), 1.0, 0.5)  # alive for the probe
        donor.publish_state(ref_st.pack_state([np.full(72, np.nan, np.float32)],
                                              meta={"clock": 1.0, "step": 1, "loss": 0.5}))
        rejoiner.transport.set_peer_port(0, donor.port)
        before = rejoiner.vector().clone()
        assert bootstrap_from_peer(rejoiner.transport) is None
        assert not rejoiner._bootstrap_from_peer() and rejoiner.last_bootstrap is None
        assert torch.equal(rejoiner.vector(), before) and rejoiner.step == 0
        # A sane state then lands.
        donor.publish_state(ref_st.pack_state([np.full(72, 2.0, np.float32)],
                                              meta={"clock": 9.0, "step": 8, "loss": 0.5}))
        assert rejoiner._bootstrap_from_peer()
        assert (rejoiner.step, rejoiner.clock) == (8, 9.0)
        assert torch.equal(rejoiner.vector(), torch.full((72,), 2.0))
    finally:
        donor.close()
        rejoiner.close()


def _resync_run(kinds):
    """Node 0 misses node 1 (a closed port) and quarantines it while node 1
    trains alone far ahead; when node 1 is reachable again node 0's probe
    sees its clock lead past max_clock_lag=4 and, under auto_resync,
    adopts node 1's vector and clock, keeping its own step."""
    cfgs = _configs(schedule="ring", interpolation="constant", factor=0.3,
                    recovery={"max_clock_lag": 4.0, "auto_resync": True})
    adapters = [_adapter(k, i, cfgs) for i, k in enumerate(kinds)]
    try:
        closed = _closed_port()
        adapters[0].transport.set_peer_port(1, closed)
        adapters[1].transport.set_peer_port(0, closed)
        for r in range(30):
            adapters[1].update(0.5)
        for r in range(3):
            adapters[0].update(0.5)
        adapters[0].transport.set_peer_port(1, adapters[1].transport.port)
        advice = None
        for r in range(40):
            before = (adapters[0].step, _vec(adapters[0]).tobytes())
            adapters[0].update(0.5)
            if isinstance(adapters[0], RefAdapter):
                resynced = adapters[0]._clock == adapters[1]._clock
            else:
                advice = adapters[0].last_resync_advice
                resynced = advice is not None
            if resynced:
                break
        assert resynced, "no re-sync advice in 40 rounds"
        return (r, before[0], adapters[0].step, adapters[0]._clock, adapters[1]._clock,
                _vec(adapters[0]).tobytes() == _vec(adapters[1]).tobytes(), advice)
    finally:
        for a in adapters:
            a.close()


@pytest.mark.parametrize("kinds", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_resync_advice_and_auto_resync_as_reference(kinds):
    want = _resync_run(("ref", "ref"))
    got = _resync_run(kinds)
    assert got[:6] == want[:6]
    r, step_before, step, clock, donor_clock, same_vector, _ = got
    assert step == step_before + 1  # the step kept (and advanced by the round)
    assert clock == donor_clock == 30.0 and same_vector
    if kinds[0] == "port":
        advice = got[6]
        assert advice["peer"] == 1 and advice["remote_clock"] == 30.0
        assert advice["remote_clock"] - advice["local_clock"] > 4.0


def test_served_state_is_what_the_reference_serves():
    """After the same rounds, the bytes a port node serves for a bootstrap
    are the bytes a reference node serves in its place (and its eager
    ``_packed_state``)."""
    cfgs = _configs(schedule="ring", interpolation="clock", factor=0.7)
    blobs = {}
    for kinds in (("ref", "ref"), ("port", "ref")):
        adapters = [_adapter(k, i, cfgs) for i, k in enumerate(kinds)]
        try:
            _wire_adapters(adapters)
            for r in range(3):
                for a in adapters:
                    a.transport.publish(_vec(a) if isinstance(a, RefAdapter)
                                        else a.vector(), a._clock + 1.0, 0.5 + r)
                for a in adapters:
                    a.update(0.5 + r)
            served = tcp.fetch_state("127.0.0.1", adapters[0].transport.port, 2000)[0]
            blobs[kinds] = (served, adapters[0]._packed_state())
        finally:
            for a in adapters:
                a.close()
    want = blobs[("ref", "ref")][0]
    assert blobs[("port", "ref")] == (want, want)
    assert unpack_state(want)[1] == {"kind": "tcp_adapter", "clock": 3.0, "step": 3, "loss": 2.5}


_IMPORT_PROBE = """
import runpy, sys
import dpwa_tpu_torch, dpwa_tpu_torch.recovery, dpwa_tpu_torch.health
import dpwa_tpu_torch.adapters.tcp_adapter, dpwa_tpu_torch.recovery.bootstrap
assert dpwa_tpu_torch.recovery.bootstrap_from_peer and dpwa_tpu_torch.health.Scoreboard
sys.argv = ["chip_smoke.py", "--help"]
try:
    runpy.run_path("chip_smoke.py", run_name="__main__")
except SystemExit:
    pass
bad = sorted(m for m in sys.modules if m in ("jax", "dpwa_tpu") or m.startswith(("jax.", "dpwa_tpu.")))
print("FORBIDDEN", bad)
"""


def test_recovery_and_health_import_neither_jax_nor_the_reference():
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
