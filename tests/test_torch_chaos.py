"""The port's chaos harness against the reference's, on the CPU.

Mirrors ``tests/test_health.py``'s chaos tests (``test_chaos_*``) and the
fault cases of ``tests/test_trust.py`` (``test_byzantine_frame_*``):

- ``chaos_draw`` bit-equal over a grid, and ``ChaosConfig`` accepting and
  rejecting the same dicts;
- ``ChaosEngine.plan`` (and ``down``, ``link_blocked``, the trickle,
  bandwidth and accept-delay rates) equal over a (round, peer) grid for
  every fault kind, the windows and the partitions;
- ``mutate_frame`` and ``byzantine_frame`` byte-equal on f32 and bf16
  frames that carry the digest trailer, and on int8-chunked and top-k
  bodies;
- a port ``ChaosPeerServer`` and a reference one, at the same config and
  serving the same frames, put the same bytes on the wire for each fault
  kind, replays and relayed probes of a partitioned target included.

Every socket binds port 0.
"""

import dataclasses
import socket
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from dpwa_tpu import config as ref_config
from dpwa_tpu.health import chaos as ref_chaos
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch import config
from dpwa_tpu_torch.health import chaos
from dpwa_tpu_torch.membership import digest
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel import schedules
from dpwa_tpu_torch.parallel import tcp

ENGINE_CONFIGS = {
    "wire": dict(drop_probability=0.2, delay_probability=0.2, throttle_probability=0.2,
                 truncate_probability=0.2, corrupt_probability=0.2, delay_ms=7.0),
    "byzantine": dict(byzantine_sign_probability=0.2, byzantine_scale_probability=0.2,
                      byzantine_replay_probability=0.2, byzantine_zero_probability=0.2,
                      byzantine_peers=(1, 3), byzantine_start_round=5, byzantine_scale_factor=3.5,
                      byzantine_replay_age=3),
    "shaping": dict(stall_probability=0.5, stall_ms_max=80.0, trickle_windows=((1, 3, 9),),
                    accept_delay_windows=((2, 0, 4),), down_windows=((0, 5, 7),),
                    drop_probability=0.1),
    "bandwidth": dict(bandwidth_windows=((1, 0, 50), (3, 10, 20)), bandwidth_flap_probability=0.6,
                      bandwidth_block_rounds=3, bandwidth_bps_min=1000.0,
                      bandwidth_bps_max=9000.0, trickle_windows=((1, 6, 30),),
                      trickle_bytes_per_s=4000.0),
    "partitions": dict(partition_windows=(((0, 1), 2, 6),), link_windows=((2, 3, 1, 9),),
                       partition_probability=0.5, partition_len_rounds=4, seed=11),
}


def _engines(kw, peer):
    kw = dict(kw, enabled=True)
    return (chaos.ChaosEngine(config.ChaosConfig(**kw), peer),
            ref_chaos.ChaosEngine(ref_config.ChaosConfig(**kw), peer))


@pytest.mark.parametrize("name", list(ENGINE_CONFIGS))
def test_engine_plans_equal_to_reference(name):
    for peer in range(4):
        mine, ref = _engines(ENGINE_CONFIGS[name], peer)
        for r in range(0, 40):
            assert dataclasses.asdict(mine.plan(r)) == dataclasses.asdict(ref.plan(r)), (peer, r)
            assert mine.plan(r).faulty == ref.plan(r).faulty
            assert (mine.down(r), mine.trickle_bps(r), mine.bandwidth_bps(r),
                    mine.accept_delay_s(r)) == (ref.down(r), ref.trickle_bps(r),
                                                ref.bandwidth_bps(r), ref.accept_delay_s(r))
            for dst in range(4):
                assert mine.link_blocked(r, peer, dst) == ref.link_blocked(r, peer, dst)


def test_chaos_draw_bit_equal_to_reference():
    assert schedules.CHAOS_TAG_BASE == ref_schedules.CHAOS_TAG_BASE
    for seed in (0, 5, 123):
        for step in (0, 1, 2, 17, 4096):
            for peer in (0, 2, 9):
                for kind in range(15):
                    got = schedules.chaos_draw(seed, step, peer, kind)
                    assert got == ref_schedules.chaos_draw(seed, step, peer, kind)


CHAOS_DICTS = [
    {}, {"enabled": True, "seed": 3, "drop_probability": 1.0},
    {"down_windows": [[1, 2, 3]], "trickle_windows": [{"peer": 0, "start": 1, "stop": 4}]},
    {"partition_windows": [{"group": [2, 0], "start": 1, "stop": 3}],
     "link_windows": [[0, 1, 2, 5], {"src": 1, "dst": 0, "start": 0, "stop": 1}]},
    {"byzantine_peers": [3, 1], "bandwidth_windows": [[1, 0, 9]]},
    {"drop_probability": 1.5}, {"stall_probability": -0.1}, {"byzantine_scale_factor": 0},
    {"byzantine_replay_age": 0}, {"byzantine_start_round": -1}, {"byzantine_peers": [-1]},
    {"delay_ms": -1}, {"throttle_bytes_per_s": 0}, {"partition_len_rounds": 0},
    {"trickle_bytes_per_s": 0}, {"stall_ms_max": -1}, {"accept_delay_ms": -1},
    {"bandwidth_block_rounds": 0}, {"bandwidth_bps_min": 0},
    {"bandwidth_bps_min": 10.0, "bandwidth_bps_max": 5.0}, {"down_windows": [[1, 5, 3]]},
    {"down_windows": [[1, 2]]}, {"down_windows": [{"peer": 1}]},
    {"partition_windows": [[[], 1, 2]]}, {"link_windows": [[0, 1, 5, 2]]}, {"bogus": 1},
]


def _outcome(fn):
    try:
        obj = fn()
    except Exception as e:  # the type is what must agree
        return type(e)
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_chaos_config_accepts_and_rejects_like_reference():
    for raw in CHAOS_DICTS:
        got = _outcome(lambda: config.config_from_dict({"nodes": ["a"], "chaos": raw}).chaos)
        want = _outcome(lambda: ref_config.config_from_dict({"nodes": ["a"], "chaos": raw}).chaos)
        assert got == want, raw


def _digest_bytes():
    entries = {p: digest.MemberEntry(state=p % 3, incarnation=p, suspicion=0.25 * p)
               for p in range(4)}
    return digest.encode_digest(digest.Digest(origin=1, round=9, entries=entries))


def _values(n, seed):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-40, 38, n)).astype(np.float32)
    special = np.array([np.inf, -np.inf, 0.0, -0.0, 1e-45, 3.4e38], np.float32)
    v[: min(n, 6)] = special[: min(n, 6)]
    return v


def _frames(wire, n=300, seed=0):
    """The same frame from each package, with a digest trailer."""
    v = _values(n, seed)
    trailer = _digest_bytes()
    if wire == "bf16":
        mine = tcp._frame(torch.from_numpy(v).to(torch.bfloat16), 7.0, 0.25, trailer)
        ref = ref_tcp._frame(v.astype(ml_dtypes.bfloat16), 7.0, 0.25, digest=trailer)
    else:
        mine = tcp._frame(torch.from_numpy(v), 7.0, 0.25, trailer)
        ref = ref_tcp._frame(v, 7.0, 0.25, digest=trailer)
    return mine, ref


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_mutate_and_byzantine_frames_byte_equal_to_reference(wire):
    mine, ref = _frames(wire)
    assert mine == ref
    for kind in ("none", "drop", "down", "corrupt", "truncate", "delay"):
        assert chaos.mutate_frame(mine, kind) == ref_chaos.mutate_frame(ref, kind), kind
    for kind in ("sign", "zero", "scale"):
        for scale in (100.0, 1.37, 1e-3, -2.5, 3e30):
            got = chaos.byzantine_frame(mine, kind, scale)
            assert got == ref_chaos.byzantine_frame(ref, kind, scale), (kind, scale)
            # The header and the trailer stay.
            assert got[: pc.BLOB_HDR.size] == mine[: pc.BLOB_HDR.size]
            assert got[-len(_digest_bytes()):] == _digest_bytes()


def test_byzantine_frame_of_codec_bodies_byte_equal_to_reference():
    """The int8-chunked body lies through its scales and the top-k body
    through its value block; u16 and sharded payloads stay."""
    rng = np.random.default_rng(3)
    n, k = 700, 40
    int8_body = (struct.pack("<Q", n) + _values(3, 1).tobytes()
                 + rng.integers(-127, 128, n, dtype=np.int8).tobytes())
    idx = np.sort(rng.choice(n, k, replace=False)).astype("<u4").tobytes()
    topk_f32 = struct.pack("<QIB", n, k, 0) + idx + _values(k, 2).tobytes()
    topk_int8 = (struct.pack("<QIB", n, k, 1) + idx + _values(1, 4).tobytes()
                 + rng.integers(-127, 128, k, dtype=np.int8).tobytes())
    u16 = rng.integers(0, 1 << 16, 50, dtype=np.uint16).tobytes()
    cases = [(pc.PAYLOAD_INT8_CHUNKED, int8_body), (pc.PAYLOAD_TOPK_DELTA, topk_f32),
             (pc.PAYLOAD_TOPK_DELTA, topk_int8), (pc.PAYLOAD_U16, u16),
             (pc.PAYLOAD_SHARD, b"\x01" * 40), (pc.PAYLOAD_INT8_CHUNKED, b"\x00" * 5),
             (pc.PAYLOAD_TOPK_DELTA, b"\x00" * 12), (pc.PAYLOAD_F64, _values(9, 5).astype("<f8").tobytes())]
    for code, body in cases:
        frame = pc.BLOB_HDR.pack(pc.BLOB_MAGIC, 1, code, 3.0, 0.5, len(body)) + body + _digest_bytes()
        for kind, scale in (("sign", 1.0), ("zero", 1.0), ("scale", 100.0), ("scale", -0.7)):
            assert chaos.byzantine_frame(frame, kind, scale) == ref_chaos.byzantine_frame(
                frame, kind, scale), (code, kind, scale)


def _raw_fetch(port, request=pc.BLOB_REQ):
    """Every byte a server sends for ``request``, up to its close."""
    out = b""
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            s.sendall(request)
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                out += chunk
    except OSError:
        pass
    return out


SERVER_CONFIGS = {
    "wire": dict(drop_probability=0.15, truncate_probability=0.2, corrupt_probability=0.2,
                 throttle_probability=0.2, throttle_bytes_per_s=50000.0, delay_probability=0.2,
                 delay_ms=5.0),
    "byzantine": dict(byzantine_sign_probability=0.25, byzantine_scale_probability=0.25,
                      byzantine_zero_probability=0.25, byzantine_replay_probability=0.25,
                      byzantine_replay_age=2, byzantine_scale_factor=7.0),
    "shaping": dict(trickle_windows=((0, 2, 5),), trickle_bytes_per_s=30000.0,
                    stall_probability=0.4, stall_ms_max=15.0, accept_delay_windows=((0, 6, 8),),
                    accept_delay_ms=5.0, down_windows=((0, 8, 10),)),
    "bandwidth": dict(bandwidth_windows=((0, 0, 12),), bandwidth_bps_min=20000.0,
                      bandwidth_bps_max=60000.0, bandwidth_block_rounds=2,
                      truncate_probability=0.3),
}


@pytest.mark.parametrize("name", list(SERVER_CONFIGS))
def test_chaos_server_serves_the_reference_bytes(name):
    kw = dict(SERVER_CONFIGS[name], enabled=True, seed=4)
    mine = chaos.ChaosPeerServer("127.0.0.1", 0, chaos.ChaosEngine(config.ChaosConfig(**kw), 0))
    ref = ref_chaos.ChaosPeerServer(
        "127.0.0.1", 0, ref_chaos.ChaosEngine(ref_config.ChaosConfig(**kw), 0))
    trailer = _digest_bytes()
    try:
        for r in range(1, 12):
            v = _values(96, r)
            mine.publish(torch.from_numpy(v), float(r), 0.5, trailer)
            ref.publish(v, float(r), 0.5, digest=trailer)
            assert mine._payload == ref._srv._payload
            for _ in range(2):
                assert _raw_fetch(mine.port) == _raw_fetch(ref.port), (name, r)
    finally:
        mine.close()
        ref.close()


def test_chaos_server_state_and_relay_honour_the_plan():
    """STATE chunks and relayed probes are served as the reference serves
    them: down windows serve nothing, and a relayed probe of a target
    across an injected partition reports ``refused`` without a probe."""
    kw = dict(enabled=True, seed=1, down_windows=((0, 3, 4),),
              partition_windows=(((0,), 5, 8),))
    mine = chaos.ChaosPeerServer("127.0.0.1", 0, chaos.ChaosEngine(config.ChaosConfig(**kw), 0))
    ref = ref_chaos.ChaosPeerServer(
        "127.0.0.1", 0, ref_chaos.ChaosEngine(ref_config.ChaosConfig(**kw), 0))
    target = tcp.PeerServer("127.0.0.1", 0)
    try:
        target.publish(torch.ones(4), 42.0, 0.5)
        state = bytes(range(256)) * 3
        mine.publish_state(state)
        ref.publish_state(state)
        relay = pc.RELAY_REQ + pc.RELAY_BODY.pack(1, target.port, 200, 9) + b"127.0.0.1"
        for r in (1, 3, 5, 9):
            v = np.full(8, float(r), np.float32)
            mine.publish(torch.from_numpy(v), float(r), 0.5)
            ref.publish(v, float(r), 0.5)
            for request in (pc.STATE_REQ + pc.STATE_REQ_BODY.pack(100, 64), relay):
                got, want = _raw_fetch(mine.port, request), _raw_fetch(ref.port, request)
                assert got == want, (r, request[:5])
        # Round 9: the partition is over, the relay probed the target.
        assert pc.RELAY_HDR.unpack(got)[2:] == (0, 42.0)
    finally:
        for s in (mine, ref, target):
            s.close()
