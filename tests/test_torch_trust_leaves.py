"""The port's trust screen against the reference's, on the CPU: the sums
over leaf starts, and the leaf tiling.

Each test names the test of ``tests/test_trust.py`` it mirrors.

- ``payload_stats`` with leaf starts, on the seeded vectors of
  ``tests/test_torch_trust_screen.py``: ``norm_ratio`` and ``update_ratio``
  within a relative 1e-5, ``cosine`` within 1e-5 absolute, ``leaf_ratio``
  bit for bit (``test_payload_stats_leaf_ratio_catches_one_poisoned_leaf``).
- ``leaf_starts_from_sizes`` as the reference's
  (``test_leaf_starts_from_sizes_tiling``).
"""

import numpy as np
import pytest
import torch

from dpwa_tpu.trust import screen as ref_screen
from dpwa_tpu_torch.trust import screen

RTOL = 1e-5  # norm_ratio, update_ratio (relative); cosine (absolute)


def _pair(kind, d, seed):
    rng = np.random.default_rng(seed)
    local = rng.standard_normal(d).astype(np.float32)
    remote = {
        "honest": local + 0.01 * rng.standard_normal(d).astype(np.float32),
        "uncorrelated": rng.standard_normal(d).astype(np.float32),
        "sign_flip": -local,
        "scale5": 5.0 * local,
    }.get(kind)
    if kind == "poisoned_leaf":
        remote = local.copy()
        remote[d // 3: d // 3 + 50] *= 40.0
    return local, remote.astype(np.float32)


def _sizes(d, seed):
    """Random leaf sizes tiling d (some tiny, one large), as a model has."""
    rng = np.random.default_rng(100 + seed)
    cuts = np.sort(rng.choice(np.arange(1, d), size=min(40, d - 1), replace=False))
    return np.diff(np.concatenate([[0], cuts, [d]])).tolist()


def stat_errors(d, seed, kind, leaves):
    """``(errors, mine, theirs)``: the port's payload_stats against the
    reference's on one seeded pair."""
    local, remote = _pair(kind, d, seed)
    starts = ref_screen.leaf_starts_from_sizes(_sizes(d, seed), d) if leaves else None
    theirs = ref_screen.payload_stats(local, remote, starts)
    mine = screen.payload_stats(torch.from_numpy(local), torch.from_numpy(remote), starts)
    errs = {k: abs(mine[k] - theirs[k]) / abs(theirs[k]) for k in ("norm_ratio", "update_ratio")}
    errs["cosine"] = abs(mine["cosine"] - theirs["cosine"])
    return errs, mine, theirs


@pytest.mark.parametrize("leaves", [True], ids=["leaves"])
@pytest.mark.parametrize("kind", ["honest", "uncorrelated", "sign_flip", "scale5", "poisoned_leaf"])
@pytest.mark.parametrize("d,seed", [(1000, 0), (66410, 1), (100000, 2)])
def test_payload_stats_within_rtol_of_reference(d, seed, kind, leaves):
    """Mirrors ``test_payload_stats_leaf_ratio_catches_one_poisoned_leaf``."""
    errs, mine, theirs = stat_errors(d, seed, kind, leaves)
    assert max(errs.values()) <= RTOL, errs
    assert mine["leaf_ratio"] == theirs["leaf_ratio"]  # maxima and one f32 division
    assert set(mine) == set(theirs)


@pytest.mark.parametrize("total", [10, 100, 101])
def test_leaf_starts_from_sizes_equal_reference(total):
    """Mirrors ``test_leaf_starts_from_sizes_tiling``."""
    for sizes in ([10], [3, 0, 7], [50, 50], [1] * 100, [60, 41], [], [0, 0]):
        got = screen.leaf_starts_from_sizes(sizes, total)
        want = ref_screen.leaf_starts_from_sizes(sizes, total)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got, want) and got.dtype == want.dtype
