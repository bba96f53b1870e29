"""The port's flow control plane against the reference's, on the CPU: its
pure parts.

Each test names the test of ``tests/test_flowctl.py`` it mirrors (those
reference tests bind sockets the driver's parallel runs collide on, so
their own results are no ground truth; the reference's objects are run
here on the same inputs instead).

- ``DeadlineEstimator`` fed seeded sequences of outcomes and latencies:
  ``warm``, ``deadline_ms``, ``hedge_launch_ms`` after every observation,
  and the snapshots, equal (``test_estimator_*``).
- ``AdmissionController`` on a ``VirtualClock``: every ``admit`` decision
  and retry hint, the bytes ceiling, the evictions and the snapshots equal
  (``test_admission_*``).
- ``FlowctlConfig`` accepting and rejecting the same dicts.
- ``degrade_shed_draw`` bit-equal over a grid
  (``test_degrade_shed_draw_is_deterministic_and_uniform``), and the
  ``DPWB`` frame byte-equal (``test_busy_frame_is_shorter_than_a_blob_header``).
"""

import dataclasses

import numpy as np
import pytest

from dpwa_tpu import config as ref_config
from dpwa_tpu.flowctl import AdmissionController as RefAdmission
from dpwa_tpu.flowctl import DeadlineEstimator as RefEstimator
from dpwa_tpu.flowctl.vclock import VirtualClock as RefClock
from dpwa_tpu.parallel import protocol_constants as ref_pc
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch import config
from dpwa_tpu_torch.flowctl import AdmissionController, DeadlineEstimator
from dpwa_tpu_torch.flowctl.vclock import VirtualClock
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel import schedules
from dpwa_tpu_torch.parallel import tcp

OUTCOMES = (Outcome.SUCCESS, Outcome.SUCCESS, Outcome.SUCCESS, Outcome.BUSY, Outcome.SLOW,
            Outcome.TIMEOUT, Outcome.SHORT_READ, Outcome.POISONED)
ESTIMATOR_CONFIGS = [
    {},
    dict(quantile=1.0, margin=2.0, min_ms=1.0, max_ms=10_000.0, warmup=3, window=8),
    dict(quantile=0.5, margin=1.0, min_ms=300.0, max_ms=500.0, warmup=1, window=4),
    dict(quantile=0.9, margin=3.0, min_ms=20.0, max_ms=60.0, warmup=2, window=2),
]


def _both(kw):
    return config.FlowctlConfig(**kw), ref_config.FlowctlConfig(**kw)


@pytest.mark.parametrize("kw", ESTIMATOR_CONFIGS)
def test_estimator_equal_to_reference_on_seeded_sequences(kw):
    """Mirrors ``test_estimator_cold_falls_back_to_timeout_and_never_hedges``,
    ``..._quantile_margin_and_clamp``, ``..._failures_never_enter_the_latency_window``
    and ``..._window_is_bounded_and_snapshot_shape``, on one seeded stream."""
    mine_cfg, ref_cfg = _both(kw)
    mine, ref = DeadlineEstimator(mine_cfg, timeout_ms=400.0), RefEstimator(ref_cfg, timeout_ms=400.0)
    rng = np.random.default_rng(len(kw))
    for i in range(300):
        peer = int(rng.integers(4))
        outcome = OUTCOMES[int(rng.integers(len(OUTCOMES)))]
        latency = None if rng.random() < 0.05 else float(rng.lognormal(-4.0, 1.5))
        for est in (mine, ref):
            est.observe(peer, outcome, latency_s=latency, nbytes=int(rng.integers(1 << 20)))
        if i % 17 == 0:
            mine.note_hedge(peer)
            ref.note_hedge(peer)
        if i % 29 == 0:
            mine.note_hedge_win(peer)
            ref.note_hedge_win(peer)
        if i == 150:
            mine.evict_peer(peer)
            ref.evict_peer(peer)
        for p in range(5):
            assert mine.warm(p) == ref.warm(p)
            assert mine.deadline_ms(p) == ref.deadline_ms(p)
            assert mine.hedge_launch_ms(p) == ref.hedge_launch_ms(p)
        if i % 50 == 0:
            assert mine.snapshot() == ref.snapshot()
    assert mine.snapshot() == ref.snapshot()
    assert mine.tracked_peers() == ref.tracked_peers()


ADMISSION_CONFIGS = [
    dict(max_connections=2, token_rate=1e6, token_burst=1e6),
    dict(max_connections=100, token_rate=1.0, token_burst=2.0, busy_retry_ms=10),
    dict(max_connections=3, token_rate=7.5, token_burst=3.0, max_inflight_bytes=100),
    {},
]


@pytest.mark.parametrize("kw", ADMISSION_CONFIGS)
def test_admission_equal_to_reference_on_a_virtual_clock(kw):
    """Mirrors ``test_admission_connection_cap_and_release``,
    ``test_admission_token_bucket_refills_on_the_injected_clock`` and
    ``test_admission_inflight_bytes_ceiling`` on one seeded stream of
    admits, releases, reservations, evictions and clock advances."""
    mine_cfg, ref_cfg = _both(kw)
    mine_clock, ref_clock = VirtualClock(), RefClock()
    mine = AdmissionController(mine_cfg, clock=mine_clock)
    ref = RefAdmission(ref_cfg, clock=ref_clock)
    rng = np.random.default_rng(7 + len(kw))
    hosts = ("a", "b", "10.0.0.3")
    for _ in range(400):
        op = int(rng.integers(6))
        host = hosts[int(rng.integers(len(hosts)))]
        if op == 0 or op == 1:
            assert mine.admit(host) == ref.admit(host)
        elif op == 2:
            mine.release(host)
            ref.release(host)
        elif op == 3:
            n = int(rng.integers(80))
            assert mine.reserve_bytes(n) == ref.reserve_bytes(n)
            if rng.random() < 0.5:
                mine.release_bytes(n)
                ref.release_bytes(n)
        elif op == 4:
            dt = float(rng.exponential(0.3))
            assert mine_clock.advance(dt) == ref_clock.advance(dt)
        else:
            mine.note_eviction()
            ref.note_eviction()
        assert mine.snapshot() == ref.snapshot()
        assert mine.shed_total == ref.shed_total
    with pytest.raises(ValueError):
        mine_clock.advance(-1.0)


FLOWCTL_DICTS = [
    {}, {"enabled": False}, {"quantile": 1.0, "margin": 1.0, "min_ms": 1.0, "max_ms": 1.0},
    {"warmup": 32, "window": 32}, {"degrade_shed_fraction": 1.0, "hedge": False},
    {"quantile": 0.0}, {"quantile": 1.5}, {"margin": 0.99}, {"min_ms": 0.0},
    {"min_ms": 10.0, "max_ms": 5.0}, {"window": 1}, {"warmup": 0}, {"warmup": 33},
    {"degrade_shed_fraction": -0.1}, {"max_connections": 0}, {"reactor_max_connections": 0},
    {"token_rate": 0.0}, {"token_burst": 0.5}, {"max_inflight_bytes": 0},
    {"min_ingest_bytes_per_s": 0.0}, {"request_timeout_ms": 0}, {"busy_retry_ms": -1},
    {"bogus": 1}, {"max_connections": "many"},
]


def _outcome(fn):
    try:
        obj = fn()
    except Exception as e:  # the type is what must agree
        return type(e)
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_flowctl_config_accepts_and_rejects_like_reference():
    for raw in FLOWCTL_DICTS:
        got = _outcome(lambda: config.config_from_dict({"nodes": ["a"], "flowctl": raw}).flowctl)
        want = _outcome(
            lambda: ref_config.config_from_dict({"nodes": ["a"], "flowctl": raw}).flowctl)
        assert got == want, raw
        assert got == _outcome(lambda: config.make_local_config(1, flowctl=raw).flowctl), raw


def test_degrade_shed_draw_bit_equal_to_reference():
    """Mirrors ``test_degrade_shed_draw_is_deterministic_and_uniform``."""
    for seed in (0, 3, 4, 123456):
        for step in (0, 1, 2, 7, 31, 4096, 2**31 - 1):
            for me in (0, 1, 5, 63):
                got = schedules.degrade_shed_draw(seed, step, me)
                assert type(got) is float and 0.0 <= got < 1.0
                assert got == ref_schedules.degrade_shed_draw(seed, step, me)


def test_busy_frame_byte_equal_to_reference():
    """Mirrors ``test_busy_frame_is_shorter_than_a_blob_header``."""
    assert (pc.BUSY_MAGIC, pc.BUSY_HDR_FMT) == (ref_pc.BUSY_MAGIC, ref_pc.BUSY_HDR_FMT)
    assert pc.BACK_COMPAT["busy_nack_short_frame"]
    for hint in (-5, 0, 25, 50, 0xFFFF, 1 << 30, 3.7):
        assert tcp._busy_frame(hint) == ref_tcp._busy_frame(hint)
    frame = tcp._busy_frame(50)
    assert len(frame) == pc.BUSY_HDR.size == 7 < pc.BLOB_HDR.size
