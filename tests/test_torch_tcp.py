"""The port's TCP transport against the reference's, over real localhost
sockets on the CPU.

- The blob protocol's constants, and the frames ``_frame`` builds, byte
  for byte on the f32 and bf16 wires (a NaN of each sign, an inf, a
  subnormal, an empty vector): the bf16 rounding is the reference's
  (``ml_dtypes``), not ``Tensor.to(torch.bfloat16)``, whose NaN differs.
- Each package's fetcher against the other's Rx server, both wires; each
  outcome class (refused, short_read, corrupt, busy, timeout) produced the
  same way by both fetchers against the same faulty server; the STATE
  request answered as the reference's server answers it with no state.
- A mixed pair, one ``dpwa_tpu`` node and one ``dpwa_tpu_torch`` node, run
  lock-step (every node publishes before any exchanges, as ``bench.py``'s
  TCP leg) for 5 rounds at α ≠ 0.5 (clock interpolation, unequal clocks):
  every merge bit-equal to an all-reference pair's, on both wires, with the
  reference node's health, membership, trust and flowctl planes off; and
  with the reference node at its default planes, every round succeeding.
  The merge is ``fma(1-α, x, α·y)``: g++'s contraction of
  ``native.merge_out`` and XLA's lerp both fuse the local product, which
  the first test pins against both at α = 0.3.
- ``exchange_on_device`` on CPU tensors against the reference's on CPU JAX
  arrays (its device merge engine), both wires.
- The payload guard: a frame with a NaN is not merged and is classified
  ``poisoned`` (``nonfinite_params``), as the reference classifies it.

Every node binds port 0 and is wired with ``set_peer_port``; every socket
has a timeout and every transport is closed in a ``finally``.
"""

import dataclasses
import socket
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dpwa_tpu import native
from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.device import kernels as ref_kernels
from dpwa_tpu.parallel import protocol_constants as ref_pc
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.device.replica import DeviceReplica
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.ops import merge
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel import tcp

PLANES_OFF = dict(
    health={"enabled": False}, membership={"enabled": False},
    trust={"enabled": False}, flowctl={"enabled": False},
)
WIRES = ["f32", "bf16"]


@pytest.fixture(autouse=True)
def _socket_timeout():
    prev = socket.getdefaulttimeout()
    socket.setdefaulttimeout(10.0)
    try:
        yield
    finally:
        socket.setdefaulttimeout(prev)


def _ephemeral(cfg):
    """Every node on port 0: the OS picks, no fixed port can collide."""
    return dataclasses.replace(
        cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes)
    )


def _wire_up(nodes):
    for t in nodes:
        for i, other in enumerate(nodes):
            t.set_peer_port(i, other.port)


def _odd_values(n, seed):
    v = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    v[:6] = [np.nan, -np.nan, np.inf, 1e-40, -0.0, 3.1415927]
    return v


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_tcp_merge_form_is_one_fma_of_the_local_product():
    """The reference's two TCP merges (the host's ``native.merge_out`` and
    the device engine's XLA lerp) and the port's B2 form all give
    ``fma(1-α, x, α·y)``; ``(1-α)·x + α·y`` in two roundings does not."""
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal(4096).astype(np.float32) for _ in range(2))
    a = np.float32(0.3)
    want = (np.float64(np.float32(1) - a) * x + np.float64(a * y)).astype(np.float32)
    host = native.merge_out(x, y, float(a))
    dev = np.asarray(ref_kernels.build_dense(x.size)(jnp.asarray(x), jnp.asarray(y), a))
    port = merge.gather_merge(torch.from_numpy(x)[None], torch.zeros(1, dtype=torch.int32),
                              torch.tensor([a]), wire="int8", w=torch.from_numpy(y)[None])[0]
    assert np.array_equal(_bits(host), _bits(want)) and np.array_equal(_bits(dev), _bits(want))
    assert np.array_equal(_bits(port.numpy()), _bits(want))
    two = ((np.float32(1) - a) * x + a * y).astype(np.float32)
    assert not np.array_equal(_bits(two), _bits(want))


def test_protocol_constants_equal_reference():
    for name in ("BLOB_REQ", "STATE_REQ", "RELAY_REQ", "BLOB_MAGIC", "STATE_MAGIC",
                 "BUSY_MAGIC", "PAYLOAD_F32", "PAYLOAD_F64", "PAYLOAD_U16", "PAYLOAD_BF16",
                 "PAYLOAD_INT8_CHUNKED", "PAYLOAD_TOPK_DELTA", "PAYLOAD_SHARD",
                 "CODEC_PAYLOAD_CODES", "MAX_BLOB_BYTES"):
        assert getattr(pc, name) == getattr(ref_pc, name), name
    for name in ("BLOB_HDR", "BUSY_HDR", "STATE_REQ_BODY", "STATE_HDR"):
        assert getattr(pc, name).format == getattr(ref_pc, name).format, name


@pytest.mark.parametrize("n", [0, 1, 1000])
@pytest.mark.parametrize("wire", WIRES)
def test_frames_byte_identical_to_reference(wire, n):
    vec = _odd_values(max(n, 6), n)[:n]
    ref_vec = vec.astype(ml_dtypes.bfloat16) if wire == "bf16" else vec
    payload = DeviceReplica(torch.from_numpy(vec.copy())).payload(wire)
    assert tcp._frame(payload, 7.0, -0.25) == ref_tcp._frame(ref_vec, 7.0, -0.25)


@pytest.mark.parametrize("wire", WIRES)
def test_fetchers_read_the_other_packages_server(wire):
    vec = _odd_values(3000, 1)
    ref_vec = vec.astype(ml_dtypes.bfloat16) if wire == "bf16" else vec
    ref_srv = ref_tcp.PeerServer("127.0.0.1", 0)
    port_srv = tcp.PeerServer("127.0.0.1", 0)
    try:
        ref_srv.publish(ref_vec, 3.0, 0.5)
        port_srv.publish(DeviceReplica(torch.from_numpy(vec)).payload(wire), 3.0, 0.5)
        got, outcome, _lat, nbytes = tcp.fetch_blob_full("127.0.0.1", ref_srv.port, 2000)
        assert outcome == Outcome.SUCCESS and got[1:] == (3.0, 0.5)
        assert nbytes == ref_vec.nbytes
        assert got[0].dtype == (torch.bfloat16 if wire == "bf16" else torch.float32)
        assert np.array_equal(got[0].view(torch.int16).numpy() if wire == "bf16" else got[0].numpy(),
                              ref_vec.view(np.int16) if wire == "bf16" else ref_vec, equal_nan=wire != "bf16")
        ref_got, ref_outcome, _lat, _n, _d, _o = ref_tcp.fetch_blob_full(
            "127.0.0.1", port_srv.port, 2000)
        assert ref_outcome == "success" and ref_got[1:] == (3.0, 0.5)
        assert ref_got[0].dtype == ref_vec.dtype
        assert ref_got[0].tobytes() == ref_vec.tobytes()
        assert port_srv._payload == ref_srv._payload
    finally:
        ref_srv.close()
        port_srv.close()


class _FaultyServer:
    """Accepts connections on port 0 and answers each with ``reply`` bytes
    (None: read the request and then stay silent until closed)."""

    def __init__(self, reply):
        self.reply = reply
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self._sock.settimeout(0.1)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._conns = []
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                continue
            conn.settimeout(5.0)
            self._conns.append(conn)
            try:
                conn.recv(5)
                if self.reply is not None:
                    conn.sendall(self.reply)
                    conn.close()
            except OSError:
                pass

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        for c in self._conns:
            c.close()
        self._sock.close()


def _closed_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_HDR = pc.BLOB_HDR
FAULTS = {
    "short_read": (_HDR.pack(b"DPWA", 1, 0, 1.0, 0.0, 400) + b"\0" * 100, Outcome.SHORT_READ),
    "bad_magic": (_HDR.pack(b"XXXX", 1, 0, 1.0, 0.0, 4) + b"\0" * 4, Outcome.CORRUPT),
    "bad_version": (_HDR.pack(b"DPWA", 2, 0, 1.0, 0.0, 4) + b"\0" * 4, Outcome.CORRUPT),
    "oversize": (_HDR.pack(b"DPWA", 1, 0, 1.0, 0.0, (1 << 34) + 4), Outcome.CORRUPT),
    "busy": (pc.BUSY_HDR.pack(b"DPWB", 1, 25), Outcome.BUSY),
    "short_header": (b"DPW", Outcome.SHORT_READ),
    "silent": (None, Outcome.TIMEOUT),
}


@pytest.mark.parametrize("fault", list(FAULTS) + ["refused"])
def test_outcome_classes_match_reference(fault):
    if fault == "refused":
        port, server, want = _closed_port(), None, Outcome.REFUSED
    else:
        reply, want = FAULTS[fault]
        server = _FaultyServer(reply)
        port = server.port
    try:
        got, outcome, _lat, _n = tcp.fetch_blob_ex("127.0.0.1", port, 300)
        _ref_got, ref_outcome, _lat, _n = ref_tcp.fetch_blob_ex("127.0.0.1", port, 300)
        _ref_got, ref_full_outcome, _lat, _n, _d, _o = ref_tcp.fetch_blob_full(
            "127.0.0.1", port, 300)
        assert got is None and outcome == ref_outcome == ref_full_outcome == want
    finally:
        if server is not None:
            server.close()


def test_state_request_gets_the_empty_transfer():
    srv = tcp.make_peer_server("127.0.0.1", 0)
    assert isinstance(srv, tcp.PeerServer)
    try:
        with socket.create_connection(("127.0.0.1", srv.port), timeout=5.0) as s:
            s.sendall(pc.STATE_REQ + pc.STATE_REQ_BODY.pack(0, 1 << 20))
            reply = b""
            while len(reply) < pc.STATE_HDR.size:
                chunk = s.recv(64)
                if not chunk:
                    break
                reply += chunk
        assert pc.STATE_HDR.unpack(reply) == (b"DPWS", 1, 0, 0, 0, 0, 0)
        blob, outcome, _lat, _n = ref_tcp.fetch_state("127.0.0.1", srv.port, 2000)
        assert blob == b"" and outcome == "success"
    finally:
        srv.close()


def _pair(kinds, wire, planes=PLANES_OFF):
    """Two wired nodes, ``kinds[i]`` "ref" or "port", clock interpolation."""
    kw = dict(schedule="ring", interpolation="clock", factor=0.7, wire_dtype=wire)
    ref_cfg = _ephemeral(ref_config(2, base_port=0, **kw, **planes))
    port_cfg = _ephemeral(make_local_config(2, **kw))
    nodes = []
    try:
        for i, kind in enumerate(kinds):
            nodes.append(ref_tcp.TcpTransport(ref_cfg, f"node{i}") if kind == "ref"
                         else tcp.TcpTransport(port_cfg, f"node{i}", device="cpu"))
        _wire_up(nodes)
    except BaseException:
        for t in nodes:
            t.close()
        raise
    return nodes


def _lockstep(nodes, vecs, rounds, on_device=False):
    """Every node publishes, then every node exchanges; node i's clock is
    round + 1 + 2i, so α = 0.7·c_j / (c_i + c_j) ≠ 0.5 moves every round.
    Returns each round's merged vectors (float32 numpy) and (α, outcome)
    per node."""
    history = []
    for r in range(rounds):
        clocks = [r + 1.0 + 2 * i for i in range(len(nodes))]
        for t, v, c in zip(nodes, vecs, clocks):
            t.publish(np.asarray(v) if isinstance(t, ref_tcp.TcpTransport) else v, c, 0.5)
        out = []
        for t, v, c in zip(nodes, vecs, clocks):
            if on_device:
                merged, alpha, _ = t.exchange_on_device(v, c, 0.5, r)
            else:
                merged, alpha, _ = t.exchange(v, c, 0.5, r)
            out.append((merged, alpha, t.last_round.get("outcome")))
        vecs = [m for m, _, _ in out]
        history.append(([np.asarray(m, np.float32).copy() for m in vecs],
                        [(a, o) for _, a, o in out]))
    return history


@pytest.mark.parametrize("wire", WIRES)
def test_mixed_pair_merges_bit_equal_to_reference_pair(wire):
    start = [np.random.default_rng(i).standard_normal(5000).astype(np.float32) for i in range(2)]
    runs = {}
    for kinds in (("ref", "ref"), ("ref", "port"), ("port", "ref")):
        nodes = _pair(kinds, wire)
        try:
            vecs = [v.copy() if k == "ref" else torch.from_numpy(v.copy())
                    for k, v in zip(kinds, start)]
            runs[kinds] = _lockstep(nodes, vecs, rounds=5)
        finally:
            for t in nodes:
                t.close()
    want = runs[("ref", "ref")]
    for kinds, got in runs.items():
        for r, ((vecs, info), (want_vecs, want_info)) in enumerate(zip(got, want)):
            assert info == want_info, (kinds, r)
            for v, w in zip(vecs, want_vecs):
                assert np.array_equal(_bits(v), _bits(w)), (kinds, r)
    alphas = [a for _, info in want for a, o in info]
    assert all(o == "success" for _, info in want for _, o in info)
    assert all(a not in (0.0, 0.5) for a in alphas) and len(set(alphas)) > 2


@pytest.mark.parametrize("wire", WIRES)
def test_mixed_pair_with_reference_default_planes_every_round_succeeds(wire):
    nodes = _pair(("ref", "port"), wire, planes={})
    try:
        start = [np.random.default_rng(i).standard_normal(5000).astype(np.float32) for i in range(2)]
        hist = _lockstep(nodes, [start[0], torch.from_numpy(start[1])], rounds=4)
        for vecs, info in hist:
            assert [o for _, o in info] == ["success", "success"]
            assert all(a > 0 for a, _ in info) and all(np.isfinite(v).all() for v in vecs)
        # The reference node appended its membership digest after every
        # payload; the port's fetcher read header + nbytes and stopped.
        assert nodes[1].last_fetch["nbytes"] == start[0].nbytes // (2 if wire == "bf16" else 1)
    finally:
        for t in nodes:
            t.close()


@pytest.mark.parametrize("wire", WIRES)
def test_exchange_on_device_matches_reference_device_engine(wire):
    start = [np.random.default_rng(10 + i).standard_normal(4000).astype(np.float32) for i in range(2)]
    runs = {}
    for kind in ("ref", "port"):
        nodes = _pair((kind, kind), wire)
        try:
            vecs = [jnp.asarray(v) if kind == "ref" else torch.from_numpy(v.copy()) for v in start]
            runs[kind] = _lockstep(nodes, vecs, rounds=4, on_device=True)
            if kind == "port":
                assert [(t.stats["rounds"], t.stats["merged"]) for t in nodes] == [(4, 4)] * 2
        finally:
            for t in nodes:
                t.close()
    for (got, info), (want, want_info) in zip(runs["port"], runs["ref"]):
        assert info == want_info
        for v, w in zip(got, want):
            assert np.array_equal(_bits(v), _bits(w))


def test_poisoned_frame_is_not_merged():
    """A NaN in the partner's frame: both packages' guards refuse it before
    the merge (``poisoned``, ``nonfinite_params``) and keep their replica."""
    sick = np.ones(300, np.float32)
    sick[17] = np.nan
    srv = ref_tcp.PeerServer("127.0.0.1", 0)
    nodes = _pair(("ref", "port"), "f32")
    try:
        srv.publish(sick, 2.0, 0.1)
        mine = torch.full((300,), 0.5)
        for t in nodes:
            t.set_peer_port(1 - t.me, srv.port)
        got_ref = nodes[0].exchange(mine.numpy().copy(), 1.0, 0.1, 0)
        got_port = nodes[1].exchange(mine.clone(), 1.0, 0.1, 0)
        for t, (merged, alpha, _p) in zip(nodes, (got_ref, got_port)):
            assert t.last_fetch["outcome"] == "poisoned"
            assert t.last_fetch["poison_reason"] == "nonfinite_params"
            assert alpha == 0.0 and np.array_equal(np.asarray(merged), mine.numpy())
        assert nodes[1].stats["merged"] == 0 and nodes[1].stats["outcomes"] == {"poisoned": 1}
    finally:
        srv.close()
        for t in nodes:
            t.close()


@pytest.mark.parametrize("setting", [
    dict(wire_dtype="int8"), dict(wire_codec="topk"), dict(overlap_prefetch=True),
    dict(rx_server="reactor"),
])
def test_unported_settings_raise(setting):
    cfg = _ephemeral(make_local_config(2, **setting))
    with pytest.raises(NotImplementedError, match=next(iter(setting))):
        tcp.TcpTransport(cfg, "node0", device="cpu")


def test_replica_reads_back_once_per_merge():
    """The lazy host mirror: a second publish of the same replica reuses the
    readback; a swap (a merge landed) drops it."""
    rep = DeviceReplica(torch.arange(8, dtype=torch.float32))
    first = rep.payload("f32")
    assert rep.payload("f32") is first and (rep.readbacks, rep.mirror_hits) == (1, 1)
    rep.swap(torch.ones(8))
    assert torch.equal(rep.payload("f32"), torch.ones(8)) and rep.readbacks == 2
    assert rep.payload("bf16").dtype == torch.bfloat16 and rep.readbacks == 3


def test_replica_written_in_place_is_read_back_again():
    """A tensor written in place since its last readback is read back anew
    (its version counter moved): the mirror never serves stale bytes."""
    vec = torch.arange(8, dtype=torch.float32)
    rep = DeviceReplica(vec)
    rep.payload("f32")
    norm = rep.norm()
    vec.add_(1.0)
    assert torch.equal(rep.payload("f32"), torch.arange(8, dtype=torch.float32) + 1)
    assert rep.readbacks == 2 and rep.norm() != norm


def test_publish_then_exchange_reads_back_once():
    """``publish`` adopts the tensor as the replica, so the exchange of the
    same tensor right after republishes the host mirror: one readback a
    round (``bench.py``'s publish-then-exchange loop), and two after an
    in-place write."""
    from dpwa_tpu_torch.device import handoff

    nodes = _pair(("port", "port"), "f32")
    try:
        vecs = [torch.full((64,), 1.0 + i) for i in range(2)]
        handoff.reset_handoff_stats()
        for t, v in zip(nodes, vecs):
            t.publish(v, 1.0, 0.0)
        for t, v in zip(nodes, vecs):
            merged, alpha, _ = t.exchange_on_device(v, 1.0, 0.0, 0)
            assert alpha > 0 and merged is not v
        assert handoff.handoff_stats()["d2h_readbacks"] == 2
        nodes[0].publish(vecs[0], 2.0, 0.0)
        vecs[0].add_(1.0)
        nodes[0].exchange_on_device(vecs[0], 2.0, 0.0, 1)
        assert handoff.handoff_stats()["d2h_readbacks"] == 4
    finally:
        for t in nodes:
            t.close()
