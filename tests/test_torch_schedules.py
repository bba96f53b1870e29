"""The port's gossip schedules against the reference: pools, branch maps and
the pool row of every step are equal (the random schedule's per-step
threefry draw included), and so is every peer's participation under the
participation and fault draws."""

import numpy as np
import pytest

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.parallel import schedules


def _build(module, cfg_fn, n, **kw):
    try:
        return module.build_schedule(cfg_fn(n, **kw)), None
    except (ValueError, AssertionError) as e:
        return None, e


@pytest.mark.parametrize("n", [2, 3, 8, 16])
@pytest.mark.parametrize("mode", ["pairwise", "pull"])
@pytest.mark.parametrize(
    "kw",
    [
        dict(schedule="ring"),
        dict(schedule="exponential"),
        dict(schedule="hierarchical"),
        dict(schedule="hierarchical", group_size=2, inter_period=3),
        dict(schedule="random", pool_size=16, seed=5),
    ],
)
def test_pools_and_branches_equal(n, mode, kw):
    ref, ref_err = _build(ref_schedules, ref_config, n, mode=mode, **kw)
    port, err = _build(schedules, make_local_config, n, mode=mode, **kw)
    if ref_err is not None:
        assert type(err) is type(ref_err) and str(err) == str(ref_err)
        return
    assert err is None
    np.testing.assert_array_equal(port.pool, ref.pool)
    assert port.pool.dtype == ref.pool.dtype
    if ref.branch_map is None:
        assert port.branch_map is None
    else:
        np.testing.assert_array_equal(port.branch_map, ref.branch_map)
    assert (port.period, port.pool_size, port.mode, port.name) == (
        ref.period, ref.pool_size, ref.mode, ref.name
    )
    for step in range(2 * port.period + 3):
        assert port.branch(step) == ref.branch(step)
        np.testing.assert_array_equal(port.pairing(step), ref.pairing(step))
        for i in range(n):
            assert port.partner(step, i) == ref.partner(step, i)
            assert port.participates(step, i) == ref.participates(step, i)
            p = port.partner(step, i)
            assert port.pair_id(i, p) == ref.pair_id(i, p)


@pytest.mark.parametrize(
    "kw",
    [
        dict(schedule="random", fetch_probability=0.5),
        dict(schedule="ring", fetch_probability=0.5),
        dict(schedule="ring", drop_probability=0.1),
        dict(schedule="ring", wire_dtype="int8"),
    ],
)
def test_threefry_settings_raise(kw):
    """The settings that need threefry draws used to raise here; since
    the draws and the int8 wire are ported they build as the reference's
    do, and every peer's participation follows the reference's draws."""
    ref = ref_schedules.build_schedule(ref_config(8, **kw))
    port = schedules.build_schedule(make_local_config(8, **kw))
    np.testing.assert_array_equal(port.pool, ref.pool)
    assert (port.fetch_probability, port.drop_probability, port.wire_dtype) == (
        ref.fetch_probability, ref.drop_probability, ref.wire_dtype
    )
    for step in range(6):
        for i in range(8):
            assert port.participates(step, i) == ref.participates(step, i)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_pool_builders_equal(seed):
    for n in (2, 5, 8):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(4):
            np.testing.assert_array_equal(
                schedules._random_matching(n, a), ref_schedules._random_matching(n, b)
            )
            np.testing.assert_array_equal(
                schedules._random_pull(n, a), ref_schedules._random_pull(n, b)
            )


def test_is_involution_equal():
    for perm in ([1, 0, 2], [1, 2, 0], [0], [3, 2, 1, 0], [1, 0, 3, 3]):
        p = np.array(perm)
        assert schedules.is_involution(p) == ref_schedules.is_involution(p)
