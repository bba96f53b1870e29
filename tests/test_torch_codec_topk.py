"""The top-k delta wire (payload code 5) of the port's TCP transport
against the reference's, on the CPU.

Mirrors ``tests/test_wire_topk.py`` (k and the body's size, the selection
and its tie-break, the encoder's error feedback through publishes, the
malformed-input taxonomy, served malformed frames, the sparse trust
statistics and a sign-flipping sender) and the top-k family of
``tests/test_device_engine.py`` (the scatter-lerp against the reference's
``build_topk``): frames byte-equal through several publishes of one
encoder with f32 and int8 values, a tie forced at the threshold and k = n;
each malformed body classified as the reference classifies it, over the
wire too; 2-node and 4-node mixed groups at topk 0.05 (int8 values) equal
to all-reference groups; a sign-flipping top-k sender rejected as the
reference rejects it.  Every socket binds port 0.
"""

import socket

import numpy as np
import pytest
import torch

from dpwa_tpu.device import kernels as ref_kernels
from dpwa_tpu.ops import quantize as ref_q
from dpwa_tpu.parallel import protocol_constants as ref_pc
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu.trust.screen import payload_stats_sparse as ref_stats_sparse
from dpwa_tpu_torch.device import engine
from dpwa_tpu_torch.ops import quantize as q
from dpwa_tpu_torch.parallel import tcp
from dpwa_tpu_torch.trust.screen import payload_stats_sparse
from tests.torch_codec_groups import (assert_group_equals_reference,
                                      assert_support_matches_device_engine)


@pytest.fixture(autouse=True)
def _socket_timeout():
    prev = socket.getdefaulttimeout()
    socket.setdefaulttimeout(10.0)
    try:
        yield
    finally:
        socket.setdefaulttimeout(prev)


def test_topk_k_and_nbytes_arithmetic():
    for n in (1, 7, 100, 4099):
        for frac in (1e-6, 0.05, 0.1, 0.5, 1.0):
            assert q.topk_k(n, frac) == ref_q.topk_k(n, frac)
            for vd in ("f32", "int8"):
                assert q.topk_nbytes(n, q.topk_k(n, frac), vd) == ref_q.topk_nbytes(
                    n, ref_q.topk_k(n, frac), vd)
    assert q.topk_nbytes(0, 5) == ref_q.topk_nbytes(0, 5)


@pytest.mark.parametrize("values", ["int8", "f32"])
@pytest.mark.parametrize("fraction", [0.05, 1.0])
def test_topk_frames_byte_equal_through_publishes(values, fraction):
    """One encoder of each package through five publishes of a moving
    vector (fractional clocks; at publish 2 a block of equal deltas ties
    at the threshold, so the Philox tie-break picks part of it): every
    body, its decode and the encoders' bases are the reference's."""
    rng = np.random.default_rng(0)
    n = 2000
    ref_enc, enc = ref_q.TopkEncoder(fraction, values), q.TopkEncoder(fraction, values)
    v = rng.standard_normal(n).astype(np.float32)
    for it in range(5):
        v = (v + 0.1 * rng.standard_normal(n)).astype(np.float32)
        if it == 2:
            v = ref_enc.base.copy()
            v[100:400] += np.float32(2.0)  # 300 equal deltas, k = 100 of them
        want = ref_enc.encode(v, 3, it + 0.5, 1)
        got = enc.encode(torch.from_numpy(v), 3, it + 0.5, 1).numpy()
        assert np.array_equal(got, want), it
        assert np.array_equal(enc.base.numpy(), ref_enc.base)
        dec, ref_dec = q.decode_topk_payload(want), ref_q.decode_topk_payload(want)
        assert np.array_equal(dec.indices.numpy(), ref_dec.indices)
        assert np.array_equal(dec.values.numpy(), ref_dec.values)
        local = torch.from_numpy(v * np.float32(0.5))
        assert np.array_equal(dec.densify(local).numpy(), ref_dec.densify(local.numpy()))


def _mutations():
    """The reference's malformed top-k bodies (``test_wire_topk.py``)."""
    rng = np.random.default_rng(0)
    good = bytearray(ref_q.TopkEncoder(0.25, "f32").encode(
        rng.standard_normal(64).astype(np.float32), 0, 0.0, 0).tobytes())
    n, k = 64, 16

    def head(**kw):
        b = bytearray(good)
        if "n" in kw:
            b[:8] = np.uint64(kw["n"]).tobytes()
        if "k" in kw:
            b[8:12] = np.uint32(kw["k"]).tobytes()
        if "code" in kw:
            b[12] = kw["code"]
        return bytes(b)

    def idx(i):
        b = bytearray(good)
        b[13:13 + 4 * k] = np.asarray(i, "<u4").tobytes()
        return bytes(b)

    return [bytes(good[:7]), bytes(good[:13 + 4 * (k - 2)]), bytes(good[:-3]),
            bytes(good) + b"\x00\x00", head(n=0), head(k=0), head(k=n + 1), head(code=9),
            idx(list(range(15)) + [n]), idx(list(range(15, -1, -1))),
            idx([0, 0] + list(range(2, 16)))]


def test_decode_rejects_malformed_topk_bodies_as_reference():
    for raw in _mutations():
        buf = np.frombuffer(raw, np.uint8)
        with pytest.raises(ValueError):
            ref_q.decode_topk_payload(buf)
        with pytest.raises(ValueError):
            q.decode_topk_payload(buf)


class _RawServer:
    """Serves one fixed frame to every blob request."""

    def __init__(self, frame: bytes):
        import threading

        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.frame = frame
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn:
                try:
                    conn.recv(4)
                    conn.sendall(self.frame)
                except OSError:
                    pass

    def close(self):
        self.sock.close()


def test_served_malformed_topk_frames_are_corrupt_in_both_fetchers():
    """Mirrors ``test_served_malformed_frames_classify_corrupt_never_crash``:
    a malformed code-5 body over the wire is ``corrupt`` to either
    package's fetcher; a well-formed one decodes alike."""
    good = ref_q.TopkEncoder(0.25, "int8").encode(
        np.linspace(-1, 1, 64).astype(np.float32), 0, 0.0, 0).tobytes()
    for body, want in [(m, "corrupt") for m in _mutations()[:4]] + [(good, "success")]:
        frame = ref_pc.BLOB_HDR.pack(ref_pc.BLOB_MAGIC, 1, ref_pc.PAYLOAD_TOPK_DELTA, 1.0, 0.5,
                                     len(body)) + body
        srv = _RawServer(frame)
        try:
            ref_got, ref_out = ref_tcp.fetch_blob_full("127.0.0.1", srv.port, 2000)[:2]
            got, out = tcp.fetch_blob_full("127.0.0.1", srv.port, 2000)[:2]
        finally:
            srv.close()
        assert (out, ref_out) == (want, want)
        if want == "success":
            assert np.array_equal(got[0].indices.numpy(), ref_got[0].indices)
            assert np.array_equal(got[0].values.numpy(), ref_got[0].values)


@pytest.mark.parametrize("fraction", [0.05, 0.5])
def test_topk_merge_bit_equal_to_reference_build_topk(fraction):
    """The self-lerp and B2's support form against the reference's two
    merges of a top-k frame at α 0.3, 0.5, 0.7: its host merge of the
    densified frame (the transport's), bit for bit; its device engine's
    ``build_topk`` bit for bit off the support, and on it wherever that
    engine's XLA fuses the same product (at α 0.5, and on a host whose XLA
    fuses the local product)."""
    import jax.numpy as jnp

    from dpwa_tpu.native import merge_out

    rng = np.random.default_rng(1)
    n = 3000
    x = rng.standard_normal(n).astype(np.float32)
    body = ref_q.TopkEncoder(fraction, "int8").encode(rng.standard_normal(n).astype(np.float32),
                                                      0, 1.0, 0)
    ref_p = ref_q.decode_topk_payload(body)
    payload = q.decode_topk_payload(body)
    bits = lambda t: t.numpy().view(np.int32)
    for alpha in (0.3, 0.5, 0.7):
        device = np.asarray(ref_kernels.build_topk(n, ref_p.k)(
            jnp.asarray(x), jnp.asarray(ref_p.indices.astype(np.int32)),
            jnp.asarray(ref_p.values), np.float32(alpha)))
        host = merge_out(x, ref_p.densify(x), alpha)
        got = engine.merge(torch.from_numpy(x), payload, alpha)
        assert np.array_equal(bits(got), host.view(np.int32)), alpha
        assert np.array_equal(bits(engine.merge_topk(torch.from_numpy(x), payload, alpha)),
                              bits(got)), alpha
        assert_support_matches_device_engine(got.numpy(), device, x, ref_p.indices,
                                             ref_p.values, alpha)


def test_payload_stats_sparse_as_reference():
    """Mirrors ``test_payload_stats_sparse_sign_flip_lands_at_minus_one``."""
    rng = np.random.default_rng(5)
    local = rng.standard_normal(256).astype(np.float32)
    idx = np.arange(0, 256, 4, dtype=np.uint32)
    for vals in (-local[idx], local[idx] * np.float32(1.01)):
        want = ref_stats_sparse(local, idx, vals)
        got = payload_stats_sparse(torch.from_numpy(local), torch.from_numpy(idx.astype(np.int64)),
                                   torch.from_numpy(vals))
        for key in ("cosine", "norm_ratio", "update_ratio"):
            assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-6), key
        assert got["leaf_ratio"] == pytest.approx(want["leaf_ratio"], rel=1e-6)
    assert payload_stats_sparse(torch.from_numpy(local), torch.from_numpy(idx.astype(np.int64)),
                                torch.from_numpy(-local[idx]))["cosine"] == pytest.approx(-1.0)


@pytest.mark.parametrize("kinds", [("port", "ref"), ("ref", "port", "port", "ref")])
def test_topk_mixed_group_equals_all_reference(kinds):
    """topk 0.05 with int8 values: every round's decisions, codec column and
    merged replica, and the wire snapshots, equal an all-reference group's."""
    log = assert_group_equals_reference(kinds, wire_codec="topk", topk_fraction=0.05)
    assert {e[3] for e in log} == {"success"} and {e[8] for e in log} == {"topk"}


def test_topk_sign_flipping_sender_rejected_as_reference():
    """Mirrors ``test_topk_byzantine_rejected`` (sign): node 3 of a mixed
    group serves the sign-flip of its replica through its top-k encoder from
    round 6; its partners reject it as untrusted on the support's cosine
    (``payload_stats_sparse``), as the reference's do."""
    kw = dict(wire_codec="topk", topk_fraction=0.25, liar=3, lie_from=6, rounds=10,
              trust={"window": 16, "min_window": 4, "amnesty_gap": 0, "amnesty_rounds": 0})
    log = assert_group_equals_reference(("port", "ref", "port", "ref"), **kw)
    for node in (0, 2):  # each partner's first frame of the flip
        first = next(e for e in log if e[0] >= 6 and e[1] == node and e[2] == 3)
        assert first[3:5] == ("untrusted", "rejected") and first[6] == ["cosine_floor"]
        assert first[7] == 0.0
