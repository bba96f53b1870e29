"""The port's trust screen against the reference's, on the CPU: the sums
over contiguous segments.

Each test names the test of ``tests/test_trust.py`` it mirrors. The rest
of the trust plane's tests are ``tests/test_torch_trust_leaves.py`` (the
same sums over leaf starts), ``tests/test_torch_trust_scale.py``,
``tests/test_torch_trust.py`` and ``tests/test_torch_trust_group.py``; none
holds more than 18 tests (see ROADMAP, Queue C, on the dispatch order).

- ``payload_stats`` on seeded vectors (honest, uncorrelated, sign-flip,
  5× scale, one poisoned leaf) at d up to 1e5: ``norm_ratio`` and
  ``update_ratio`` within a relative 1e-5, ``cosine`` within 1e-5
  absolute (the reference sums in one XLA program, the port in torch's
  own order; the largest differences met here and over leaf starts are
  printed by ``PYTHONPATH=. python tests/test_torch_trust_screen.py``:
  3.5e-7, 8.3e-7 and 1.1e-6), and ``leaf_ratio`` bit for bit
  (``test_payload_stats_known_values``).
- A bf16 remote is judged by its float32 value, as the reference judges it.
"""

import json

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


@pytest.mark.parametrize("leaves", [False], ids=["segments"])
@pytest.mark.parametrize("kind", ["honest", "uncorrelated", "sign_flip", "scale5", "poisoned_leaf"])
@pytest.mark.parametrize("d,seed", [(1000, 0), (66410, 1), (100000, 2)])
def test_payload_stats_within_rtol_of_reference(d, seed, kind, leaves):
    """Mirrors ``test_payload_stats_known_values``."""
    errs, mine, theirs = stat_errors(d, seed, kind, leaves)
    assert max(errs.values()) <= RTOL, errs
    assert mine["leaf_ratio"] == theirs["leaf_ratio"]  # maxima and one f32 division
    assert set(mine) == set(theirs)


def test_payload_stats_on_a_bf16_remote_judge_its_float32_value():
    local, remote = _pair("honest", 4097, 9)
    bf = torch.from_numpy(remote).to(torch.bfloat16)
    mine = screen.payload_stats(torch.from_numpy(local), bf)
    theirs = ref_screen.payload_stats(local, bf.to(torch.float32).numpy())
    assert mine["leaf_ratio"] == theirs["leaf_ratio"]
    assert abs(mine["norm_ratio"] - theirs["norm_ratio"]) <= RTOL * theirs["norm_ratio"]


if __name__ == "__main__":  # the largest differences of the screen's sums
    worst = {}
    for d, seed in ((1000, 0), (66410, 1), (100000, 2)):
        for kind in ("honest", "uncorrelated", "sign_flip", "scale5", "poisoned_leaf"):
            for leaves in (False, True):
                errs, _, _ = stat_errors(d, seed, kind, leaves)
                for k, e in errs.items():
                    worst[k] = max(worst.get(k, 0.0), e)
    print(json.dumps(worst))
