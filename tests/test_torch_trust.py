"""The port's trust manager against the reference's, on the CPU.

Each test names the test of ``tests/test_trust.py`` it mirrors.

- ``TrustManager`` and the reference's fed the same payload stream
  (honest, outliers, sign-flips, scale blow-ups, replays, a wrong shape,
  gaps that open an amnesty), each over its package's scoreboard: equal
  verdicts, α scales, trust, events and scoreboard snapshots
  (``test_screen_rejects_sign_flip_scale_blowup_and_replay``,
  ``test_trust_collapse_feeds_scoreboard_untrusted_probes``,
  ``test_amnesty_downgrades_rejection_after_long_gap``); an evicted peer
  and a wrong shape as the reference's.
- The interpolation's α bit for bit under a trust scale outside [0, 1],
  which the manager never gives (``tests/test_torch_trust_scale.py`` holds
  the scales in [0, 1]).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpwa_tpu.config import TrustConfig as RefTrustConfig
from dpwa_tpu.health import scoreboard as ref_scoreboard
from dpwa_tpu.interpolation import PeerMeta as RefPeerMeta
from dpwa_tpu.interpolation import make_interpolation as ref_interpolation
from dpwa_tpu.trust import manager as ref_manager
from dpwa_tpu_torch.config import InterpolationConfig, TrustConfig
from dpwa_tpu_torch.health import Scoreboard
from dpwa_tpu_torch.interpolation import PeerMeta, make_interpolation
from dpwa_tpu_torch.trust import manager


def _sizes(d, seed):
    """Random leaf sizes tiling d (some tiny, one large), as a model has."""
    rng = np.random.default_rng(100 + seed)
    cuts = np.sort(rng.choice(np.arange(1, d), size=min(40, d - 1), replace=False))
    return np.diff(np.concatenate([[0], cuts, [d]])).tolist()


# -- the manager on one payload stream ----------------------------------------------

def _stream(seed, d=512, n_rounds=90):
    """``(round, peer, remote, clock)`` payloads for node 0 of 4, against a
    drifting local replica: honest jitter, MAD outliers, sign-flips, 5×
    scales, replays, a wrong-length frame, and a silent stretch per peer
    that opens an amnesty."""
    rng = np.random.default_rng(seed)
    local = rng.standard_normal(d).astype(np.float32)
    clocks = {1: 0.0, 2: 0.0, 3: 0.0}
    for r in range(n_rounds):
        local = (local + 0.01 * rng.standard_normal(d)).astype(np.float32)
        peer = int(rng.integers(1, 4))
        if 30 <= r < 50 and peer == 2:
            continue  # peer 2 falls silent: amnesty when it returns
        clocks[peer] += 1.0
        u = rng.random()
        remote = (local + 0.02 * rng.standard_normal(d)).astype(np.float32)
        clock = clocks[peer]
        if r > 12:
            if u < 0.08:
                remote = -remote
            elif u < 0.14:
                remote = 5.0 * remote
            elif u < 0.22:
                remote = (local + 0.6 * rng.standard_normal(d)).astype(np.float32)
            elif u < 0.27:
                clock = clocks[peer] - 3.0
            elif u < 0.29:
                remote = remote[: d - 1]
        yield r, peer, local, remote, clock


@pytest.mark.parametrize("cfg", [{}, {"window": 16, "min_window": 4},
                                 {"damping": 2.0, "amnesty_gap": 1, "amnesty_rounds": 3}],
                         ids=["defaults", "tight", "damped"])
@pytest.mark.parametrize("seed", range(3))
def test_trust_manager_replays_reference_stream(seed, cfg):
    """Mirrors ``test_screen_rejects_sign_flip_scale_blowup_and_replay``,
    ``test_trust_collapse_feeds_scoreboard_untrusted_probes`` and
    ``test_amnesty_downgrades_rejection_after_long_gap`` on a seeded stream:
    verdicts, α scales, trust, reasons and events equal, and the untrusted
    probes land on equal scoreboards."""
    mine_sb, ref_sb = Scoreboard(4, 0, seed=seed), ref_scoreboard.Scoreboard(4, 0, seed=seed)
    mine = manager.TrustManager(4, 0, TrustConfig(**cfg), scoreboard=mine_sb)
    ref = ref_manager.TrustManager(4, 0, RefTrustConfig(**cfg), scoreboard=ref_sb)
    sizes = _sizes(512, seed)
    mine.set_leaf_sizes(sizes)
    ref.set_leaf_sizes(sizes)
    verdicts = []
    for r, peer, local, remote, clock in _stream(seed):
        got = mine.screen(peer, torch.from_numpy(remote), clock, torch.from_numpy(local), round=r)
        want = ref.screen(peer, remote, clock, local, round=r)
        assert got[:2] == want[:2], (r, peer, got, want)
        assert got[2].get("reasons") == want[2].get("reasons") and got[2]["trust"] == want[2]["trust"]
        assert mine.pop_events() == ref.pop_events()
        verdicts.append(got[0])
    assert mine.snapshot() == ref.snapshot()
    snaps = [json.loads(json.dumps(sb.snapshot(), sort_keys=True)) for sb in (mine_sb, ref_sb)]
    for s in snaps:
        for info in s["peers"].values():
            info.pop("ewma_latency_ms", None)
            info.pop("ewma_throughput_mbps", None)
    assert snaps[0] == snaps[1]
    assert {"trusted", "suspect", "rejected"} <= set(verdicts)


def test_evict_and_shape_mismatch_as_reference():
    """Mirrors ``test_shape_mismatch_rejected_even_under_amnesty``."""
    out = []
    for mgr in (manager.TrustManager(3, 0), ref_manager.TrustManager(3, 0)):
        v = np.ones(16, np.float32)
        as_t = (lambda a: torch.from_numpy(a)) if isinstance(mgr, manager.TrustManager) else (
            lambda a: a)
        first = mgr.screen(1, as_t(v[:8]), 1.0, as_t(v), round=0)[:2]
        mgr.evict_peer(1)
        out.append((first, mgr.trust(1), mgr.snapshot()["peers"]))
    assert out[0] == out[1] and out[0][0] == ("rejected", 0.0)


@pytest.mark.parametrize("scale", [1.5, -0.5])
@pytest.mark.parametrize("kind", ["constant", "clock", "loss"])
def test_interpolation_trust_scale_bit_equal_to_reference(kind, scale):
    cfg = InterpolationConfig(type=kind, factor=0.7)
    mine = make_interpolation(cfg, max_abs_loss=16e9, trust_scale=lambda: scale)
    ref = ref_interpolation(cfg, max_abs_loss=16e9, trust_scale=lambda: scale)
    for lc, ll, rc, rl in ((3.0, 0.5, 7.0, 0.25), (1.0, 2.0, 1.0, 0.5), (0.0, 1e-3, 9.0, 4.0)):
        got = mine(PeerMeta(torch.tensor([lc]), torch.tensor([ll])),
                   PeerMeta(torch.tensor([rc]), torch.tensor([rl])))
        want = ref(RefPeerMeta(jnp.float32(lc), jnp.float32(ll)),
                   RefPeerMeta(jnp.float32(rc), jnp.float32(rl)))
        assert np.float32(got[0]).view(np.int32) == np.float32(want).view(np.int32)
