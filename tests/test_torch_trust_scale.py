"""The port's trust scale against the reference's, on the CPU: the robust
baseline the screen scores against, and the interpolation's α under a
trust scale in [0, 1], the range the manager gives it.

Each test names the test of ``tests/test_trust.py`` it mirrors.
``tests/test_torch_trust.py`` holds the scales outside [0, 1].

- ``RobustBaseline`` as the reference's
  (``test_robust_baseline_zscore_floor_and_outlier``).
- The interpolation's ``trust_scale`` α bit for bit, for each interpolation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpwa_tpu.interpolation import PeerMeta as RefPeerMeta
from dpwa_tpu.interpolation import make_interpolation as ref_interpolation
from dpwa_tpu.trust import screen as ref_screen
from dpwa_tpu_torch.config import InterpolationConfig
from dpwa_tpu_torch.interpolation import PeerMeta, make_interpolation
from dpwa_tpu_torch.trust import screen


@pytest.mark.parametrize("seed", range(3))
def test_robust_baseline_equal_reference(seed):
    """Mirrors ``test_robust_baseline_zscore_floor_and_outlier``."""
    rng = np.random.default_rng(seed)
    mine, ref = screen.RobustBaseline(8), ref_screen.RobustBaseline(8)
    for x in np.concatenate([rng.standard_normal(20), [1e3, 0.0, 0.0, 0.0]]):
        for probe in (0.0, 1.0, -3.5, 1e6):
            assert mine.zscore(probe) == ref.zscore(probe)
        assert mine.snapshot() == ref.snapshot()
        mine.push(x)
        ref.push(x)
        assert len(mine) == len(ref)


@pytest.mark.parametrize("scale", [1.0, 0.7, 0.25, 0.0, 1 / 3])
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
