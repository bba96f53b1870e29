"""The sharded wire (payload code 6) of the port's TCP transport against
the reference's, on the CPU, and ``prng.permutation`` under it.

Mirrors ``tests/test_shard.py`` (the partition, ``shard_draw``'s epochs,
frames for each inner encoding, the malformed-input taxonomy, the slice-only
merge) and the shard families of ``tests/test_device_engine.py``:

- ``prng.permutation`` bit-equal to ``jax.random.permutation`` for n ∈ {1,
  2, 8, 1625, 1626, 5000} and several keys (one sort round up to 1625, two
  from 1626), and the round count on both sides of its step to three;
- ``shard_draw`` equal to the reference's over four epochs, k ∈ {2, 4, 8};
- served frames byte-equal for each inner code (f32, bf16, int8, top-k)
  through two epochs of publishes, d not divisible by k;
- each malformed body rejected as the reference rejects it;
- the slice merges bit-equal to the reference's ``build_shard`` /
  ``build_shard_topk`` and host slice merge at α = 0.3, the other slices
  untouched;
- 2-node and 4-node mixed groups at ``shard: {k: 4}`` with a top-k inner,
  and a pair at k = 3 with an int8 inner, equal to all-reference groups.

Every socket binds port 0.
"""

import socket

import jax
import numpy as np
import pytest
import torch

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.device import kernels as ref_kernels
from dpwa_tpu.native import merge_out
from dpwa_tpu.ops import quantize as ref_q
from dpwa_tpu.ops import shard as ref_shard
from dpwa_tpu.parallel import protocol_constants as ref_pc
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.device import engine
from dpwa_tpu_torch.ops import shard
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel import schedules, tcp
from dpwa_tpu_torch.utils import prng
from tests.torch_codec_groups import (_ephemeral, assert_group_equals_reference,
                                      assert_support_matches_device_engine)


@pytest.fixture(autouse=True)
def _socket_timeout():
    prev = socket.getdefaulttimeout()
    socket.setdefaulttimeout(10.0)
    try:
        yield
    finally:
        socket.setdefaulttimeout(prev)


@pytest.mark.parametrize("n", [1, 2, 8, 1625, 1626, 5000])
def test_permutation_bit_equal_to_jax(n):
    for seed in (0, 7, 2**31 - 1):
        k = prng.fold_in(prng.key(seed), 3)
        want = np.asarray(jax.random.permutation(jax.random.fold_in(jax.random.key(seed), 3), n))
        got = prng.permutation(k, n)
        assert got.dtype == np.int32 and np.array_equal(got, want), seed
    assert prng.shuffle_rounds(n) == (0 if n == 1 else 1 if n <= 1625 else 2)
    if n == 5000:  # jax's heuristic steps to 3 rounds past (2^32 - 1)^(2/3)
        assert (prng.shuffle_rounds(2642245), prng.shuffle_rounds(2642246)) == (2, 3)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_shard_draw_equal_over_four_epochs(k):
    draws = [schedules.shard_draw(11, step, k) for step in range(4 * k)]
    assert draws == [ref_schedules.shard_draw(11, step, k) for step in range(4 * k)]
    for epoch in range(4):
        assert sorted(draws[epoch * k:(epoch + 1) * k]) == list(range(k))
        assert np.array_equal(schedules.shard_permutation(11, epoch, k),
                              ref_schedules.shard_permutation(11, epoch, k))
    assert schedules.shard_draw(11, 5, 1) == 0


def _served(port: int) -> bytes:
    """A node's served frame, header and payload (not its trailers)."""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(pc.BLOB_REQ)
        data = b""
        while len(data) < pc.BLOB_HDR.size:
            data += s.recv(65536)
        nbytes = pc.BLOB_HDR.unpack_from(data, 0)[-1]
        while len(data) < pc.BLOB_HDR.size + nbytes:
            data += s.recv(65536)
    return data[:pc.BLOB_HDR.size + nbytes]


@pytest.mark.parametrize("inner", [dict(), dict(wire_dtype="bf16"), dict(wire_dtype="int8"),
                                   dict(wire_codec="topk", topk_fraction=0.1)])
def test_shard_frames_byte_equal_for_each_inner(inner):
    """Two epochs of publishes (clocks 0..7 at k = 4, d = 1001): each served
    frame, preamble and slice, is the reference's; top-k keeps one encoder a
    shard, so a shard's second frame carries its error feedback."""
    kw = dict(shard={"k": 4}, **inner)
    ref_t = ref_tcp.TcpTransport(_ephemeral(ref_config(2, base_port=0, **kw)), "node0")
    port_t = tcp.TcpTransport(_ephemeral(make_local_config(2, **kw)), "node0", device="cpu")
    rng = np.random.default_rng(2)
    v = rng.standard_normal(1001).astype(np.float32)
    try:
        for clock in range(8):
            v = (v + 0.05 * rng.standard_normal(1001)).astype(np.float32)
            ref_t.publish(v.copy(), float(clock), 0.25)
            port_t.publish(torch.from_numpy(v.copy()), float(clock), 0.25)
            want = _served(ref_t.port)
            assert _served(port_t.port) == want, clock
            idx, k, d, code = ref_pc.SHARD_HDR.unpack_from(want, ref_pc.BLOB_HDR.size)
            assert (idx, k, d) == (ref_schedules.shard_draw(0, clock, 4), 4, 1001)
        keys = ("codec", "frames", "wire_bytes", "dense_bytes", "compression_ratio")
        want_snap, got_snap = ref_t.wire_snapshot(), port_t.wire_snapshot()
        assert {k: got_snap[k] for k in keys} == {k: want_snap[k] for k in keys}
        assert got_snap["shard"] == want_snap["shard"]
    finally:
        ref_t.close()
        port_t.close()


def _mutations():
    """The reference's malformed shard bodies (``test_shard.py``)."""
    rng = np.random.default_rng(0)
    full = rng.standard_normal(64).astype(np.float32)
    lo, hi = ref_shard.shard_bounds(64, 4, 1)
    good = bytearray(ref_shard.encode_shard_payload(
        full[lo:hi].view(np.uint8), 64, 4, 1, ref_pc.PAYLOAD_F32).tobytes())
    topk = ref_shard.encode_shard_payload(
        ref_q.TopkEncoder(0.25, "f32").encode(full[lo:hi], 0, 0.0, 0), 64, 4, 1,
        ref_pc.PAYLOAD_TOPK_DELTA).tobytes()

    def head(**kw):
        b = bytearray(good)
        idx, k, d, code = ref_pc.SHARD_HDR.unpack(bytes(b[:ref_pc.SHARD_HDR.size]))
        b[:ref_pc.SHARD_HDR.size] = ref_pc.SHARD_HDR.pack(
            kw.get("idx", idx), kw.get("k", k), kw.get("d", d), kw.get("code", code))
        return bytes(b)

    return [bytes(good[:ref_pc.SHARD_HDR.size - 3]), bytes(good[:-5]), bytes(good) + b"\x00\x00",
            head(k=0), head(idx=4), head(k=8), head(k=65, idx=0, d=64), head(d=0), head(d=128),
            head(code=9), head(code=ref_pc.PAYLOAD_SHARD), topk[:ref_pc.SHARD_HDR.size + 7]]


def test_decode_rejects_malformed_shard_bodies_as_reference():
    for raw in _mutations():
        buf = np.frombuffer(raw, np.uint8)
        with pytest.raises(ValueError):
            ref_shard.decode_shard_payload(buf)
        with pytest.raises(ValueError):
            shard.decode_shard_payload(buf)
    with pytest.raises(ValueError):  # nested or unknown inner codes never encode
        shard.encode_shard_payload(torch.zeros(4, dtype=torch.uint8), 4, 2, 0, pc.PAYLOAD_SHARD)


def test_slice_merges_bit_equal_to_reference_kernels():
    """Each inner's slice merge at α 0.3: equal to the reference's
    ``build_shard`` (a dense or int8 slice estimate) and to its host merge
    of the slice; a top-k inner also against ``build_shard_topk`` off its
    support, and on it wherever that engine's XLA fuses the same product;
    the other slices bit-identical."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    d, k, alpha = 3001, 4, 0.3
    x = rng.standard_normal(d).astype(np.float32)
    for idx in range(k):
        lo, hi = ref_shard.shard_bounds(d, k, idx)
        sl = rng.standard_normal(hi - lo).astype(np.float32)
        bodies = {
            ref_pc.PAYLOAD_F32: sl.view(np.uint8),
            ref_pc.PAYLOAD_INT8_CHUNKED: ref_q.encode_int8_payload(sl, 0, 1.0, 0),
            ref_pc.PAYLOAD_TOPK_DELTA: ref_q.TopkEncoder(0.1, "int8").encode(sl, 0, 1.0, 0),
        }
        for code, inner in bodies.items():
            body = ref_shard.encode_shard_payload(inner, d, k, idx, code)
            ref_p = ref_shard.decode_shard_payload(body)
            x_sl = np.ascontiguousarray(x[lo:hi])
            est = ref_p.slice_estimate(x_sl)
            host = x.copy()
            host[lo:hi] = merge_out(x_sl, est, alpha)
            got = engine.merge(torch.from_numpy(x), shard.decode_shard_payload(body), alpha)
            assert np.array_equal(got.numpy().view(np.int32), host.view(np.int32)), (idx, code)
            if code == ref_pc.PAYLOAD_TOPK_DELTA:
                want = ref_kernels.build_shard_topk(d, hi - lo, ref_p.inner.k)(
                    jnp.asarray(x), jnp.asarray(ref_p.inner.indices.astype(np.int32)),
                    jnp.asarray(ref_p.inner.values), np.int32(lo), np.float32(alpha))
                assert np.array_equal(engine.merge_shard_topk(
                    torch.from_numpy(x), shard.decode_shard_payload(body), alpha).numpy().view(
                        np.int32), got.numpy().view(np.int32)), idx
                assert_support_matches_device_engine(
                    got.numpy(), np.asarray(want), x, lo + ref_p.inner.indices.astype(np.int64),
                    ref_p.inner.values, alpha)
            else:
                want = ref_kernels.build_shard(d, hi - lo)(
                    jnp.asarray(x), jnp.asarray(est), np.int32(lo), np.float32(alpha))
                assert np.array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32)), (idx, code)
            out = got.numpy()
            assert np.array_equal(out[:lo], x[:lo]) and np.array_equal(out[hi:], x[hi:])


@pytest.mark.parametrize("kinds,inner", [
    (("ref", "port"), dict(shard={"k": 4}, wire_codec="topk", topk_fraction=0.05)),
    (("port", "ref", "ref", "port"), dict(shard={"k": 4}, wire_codec="topk", topk_fraction=0.05)),
    (("port", "ref"), dict(shard={"k": 3}, wire_dtype="int8")),
])
def test_shard_mixed_group_equals_all_reference(kinds, inner):
    """Every round's decisions (the trust screen slice against slice, per
    (codec, shard) windows), codec column and merged replica, and the wire
    snapshots, equal an all-reference group's."""
    log = assert_group_equals_reference(kinds, **inner)
    assert {e[3] for e in log} == {"success"}
    codec = "shard+topk" if "wire_codec" in inner else "shard+int8"
    assert {e[8] for e in log} == {codec}
