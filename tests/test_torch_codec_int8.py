"""The int8-chunked wire (payload code 4) of the port's TCP transport
against the reference's, on the CPU (the quantiser's plain version).

Mirrors ``tests/test_wire_int8.py`` (the codec's frames, its edge cases,
malformed bodies, a TCP pair) and the int8 family of
``tests/test_device_engine.py`` (the fused dequant-lerp against the
decode-then-merge route), and adds what the port needs:

- frames byte-equal to ``encode_int8_payload`` (the reference's native
  path) at n ∈ {0, 1, 255, 256, 257, 4099}, fractional clocks, zero chunks;
- the quantiser's rounding, ``round(x·inv) + u`` as the reference's g++
  contracts it, on inputs searched for where one fused multiply-add of
  ``x·inv + u`` floors differently;
- B2's int8-frame form bit-equal to the reference's ``build_int8`` and to
  the dequantise-then-B2 route, at α = 0.3;
- the transport building for every codec, re-encoding at every publish;
- 2-node and 4-node mixed groups equal to all-reference groups.

Every socket binds port 0.
"""

import socket

import numpy as np
import pytest
import torch

from dpwa_tpu.device import kernels as ref_kernels
from dpwa_tpu.ops import quantize as ref_q
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.device import engine
from dpwa_tpu_torch.ops import merge, quantize as q
from dpwa_tpu_torch.parallel import tcp
from tests.torch_codec_groups import _ephemeral, assert_group_equals_reference


@pytest.fixture(autouse=True)
def _socket_timeout():
    prev = socket.getdefaulttimeout()
    socket.setdefaulttimeout(10.0)
    try:
        yield
    finally:
        socket.setdefaulttimeout(prev)


def _vector(n, seed):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * 3).astype(np.float32)
    if n > 700:
        v[256:512] = 0.0  # a zero chunk: scale 0, codes 0
        v[600] = -0.0
    return v


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 4099])
def test_int8_frames_byte_equal_to_reference(n):
    for seed, clock, sender in ((0, 0.0, 0), (3, 1.5, 1), (7, 12.25, 3), (2**31 - 1, 1e9, 65535)):
        v = _vector(n, seed)
        want = ref_q.encode_int8_payload(v, seed, clock, sender)
        got = q.encode_int8_payload(torch.from_numpy(v), seed, clock, sender)
        assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want), (seed, clock)
        assert got.numel() == q.int8_nbytes(n)
        # Decoded as the reference decodes it (views, then float(q) · s).
        dec = q.decode_int8_payload(want)
        assert np.array_equal(dec.dequantize().numpy(), ref_q.decode_int8_payload(want))
        nn, scales, codes = q.int8_payload_views(want)
        assert nn == n and codes.numel() == n and scales.numel() == q.n_chunks(n)
    assert q._np_key_words(1, 1.0, 2) != q._np_key_words(1, 1.5, 2)


def test_quantiser_rounds_the_product_then_adds_the_dither_as_the_reference():
    """``floor(round(x·inv) + u)``: the reference's g++ fuses the dither's
    ``b · 2^-24`` (exact) with the sum, not ``x · inv``.  On inputs placed
    where one fused multiply-add of ``x · inv + u`` floors otherwise, the
    port gives the reference's bytes and the fused form other bytes, so this
    fails if either package changes which product it fuses."""
    seed, clock, sender = 5, 3.0, 1
    k0, k1 = q._np_key_words(seed, clock, sender)
    n = 16 * 256
    u = q._dither(q.dither_key(k0, k1), torch.arange(n, dtype=torch.int64)).numpy()
    m = np.float32(3.0)
    inv = np.float32(1.0) / (m / np.float32(127.0))  # inexact: s = 3/127
    x = np.zeros(n, np.float32)
    x[::256] = m  # every chunk's maximum
    rng = np.random.default_rng(0)
    found = []
    for i in range(n):
        if i % 256 == 0:
            continue
        c = np.float32((float(rng.integers(-100, 100)) - float(u[i])) / float(inv))
        for _ in range(4):
            two = np.floor(np.float32(c * inv) + u[i])
            fused = float(torch.floor(torch.addcmul(torch.tensor([u[i]]), torch.tensor([c]),
                                                    torch.tensor([inv])))[0])
            if two != fused:
                x[i] = c
                found.append(i)
                break
            c = np.nextafter(c, np.float32(np.inf))
    assert len(found) >= 50, len(found)
    want = ref_q.encode_int8_payload(x, seed, clock, sender)
    got = q.encode_int8_payload(torch.from_numpy(x), seed, clock, sender).numpy()
    assert np.array_equal(got, want)
    codes = want[8 + 4 * 16:].view(np.int8)
    fused = torch.floor(torch.addcmul(torch.from_numpy(u), torch.from_numpy(x),
                                      torch.tensor(inv))).clamp(-127, 127).to(torch.int8)
    assert (fused.numpy()[found] != codes[found]).all()


def test_decode_rejects_malformed_int8_bodies():
    """Mirrors ``test_decode_rejects_malformed_payload``: a body shorter
    than its length field, or whose length disagrees with n, raises in
    both packages (the transport calls that ``corrupt``)."""
    good = ref_q.encode_int8_payload(_vector(300, 1), 0, 0.0, 0)
    bad_n = good.copy()
    bad_n[:8].view("<u8")[0] = 301
    for raw in (good[:7], good[:-1], np.concatenate([good, good[:1]]), bad_n):
        with pytest.raises(ValueError):
            ref_q.decode_int8_payload(raw)
        with pytest.raises(ValueError):
            q.decode_int8_payload(raw)
    with pytest.raises(ValueError):
        q.dequantize_flat(torch.zeros(300, dtype=torch.int8), torch.zeros(1))


@pytest.mark.parametrize("n", [1, 257, 4099])
def test_int8_frame_merge_bit_equal_to_reference_build_int8(n):
    """B2's int8-frame form, the dequantise-then-B2 route the guard's path
    takes, and the reference's fused ``build_int8`` agree bit for bit."""
    import jax.numpy as jnp

    x = _vector(n, 11) + 0.5
    body = ref_q.encode_int8_payload(_vector(n, 12), 1, 2.0, 0)
    nn, scales, codes = ref_q.int8_payload_views(body)
    for alpha in (0.3, 0.5, 0.7):
        want = np.asarray(ref_kernels.build_int8(nn, scales.size)(
            jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales), np.float32(alpha)))
        payload = q.decode_int8_payload(body)
        fused = engine.merge(torch.from_numpy(x), payload, alpha)
        dense = engine.merge(torch.from_numpy(x), payload.dequantize(), alpha)
        s, c = payload.views()
        plain = merge.torch_int8_frame_merge(torch.from_numpy(x), c, s, alpha)
        for got in (fused, dense, plain):
            assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32)), alpha


SETTINGS = [
    dict(wire_dtype="int8"), dict(wire_codec="topk"), dict(wire_codec="topk", topk_values="f32"),
    *(dict(shard={"k": k}, wire_dtype=w) for k in (2, 4, 8) for w in ("f32", "bf16", "int8")),
    *(dict(shard={"k": k}, wire_codec="topk") for k in (2, 4, 8)),
]


def test_transport_builds_for_every_codec():
    """A port transport builds for each codec and shard count, and a codec
    frame is encoded and read back at every publish (the int8 dither is
    keyed on the clock, the top-k base moves): never a stale mirror."""
    for setting in SETTINGS:
        cfg = _ephemeral(make_local_config(2, **setting))
        t = tcp.TcpTransport(cfg, "node0", device="cpu")
        try:
            v = torch.from_numpy(_vector(1000, 3))
            t.publish(v, 1.0, 0.0)
            t.publish(v, 2.0, 0.0)
            assert t._dev_replica.readbacks == 2 and t.wire_snapshot()["frames"] == 2, setting
        finally:
            t.close()


@pytest.mark.parametrize("kinds", [("ref", "port"), ("port", "ref", "ref", "port")])
def test_int8_mixed_group_equals_all_reference(kinds):
    """Every round's outcome, verdict, α and merged replica, and the wire
    snapshots, of a mixed group on the int8 wire equal an all-reference
    group's (mirrors ``test_tcp_int8_roundtrip_compression_and_merge``)."""
    log = assert_group_equals_reference(kinds, wire_dtype="int8")
    assert {e[3] for e in log} == {"success"} and {e[4] for e in log} == {"trusted"}
