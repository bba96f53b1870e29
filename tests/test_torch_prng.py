"""The port's host-side threefry against ``jax.random``.

``dpwa_tpu_torch.utils.prng`` must give the installed jax's default draws
(threefry2x32, partitionable bit generation) bit for bit: ``key``,
``fold_in``, ``split``, ``randint``, and through them the random schedule's
per-step pool row.  Each test records the jax version it compared against.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu.utils import tags as ref_tags
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.parallel import schedules
from dpwa_tpu_torch.utils import prng, tags

SEEDS = [0, 1, 2**31 - 1]
STEPS = np.arange(2001)
MAXVALS = [1, 2, 3, 16, 128]


@pytest.fixture(autouse=True)
def _jax_version(record_property):
    record_property("jax_version", jax.__version__)
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def _words(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys), dtype=np.uint64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_bit_equal(seed):
    assert prng.key(seed) == tuple(int(w) for w in _words(jax.random.key(seed)))
    base = jax.random.key(seed)
    want = _words(jax.vmap(lambda s: jax.random.fold_in(base, s))(jnp.asarray(STEPS, jnp.int32)))
    got = np.array([prng.fold_in(prng.key(seed), int(s)) for s in STEPS], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)
    for data in (2**31, 2**32 - 1):
        assert prng.fold_in(prng.key(seed), data) == tuple(
            int(w) for w in _words(jax.random.fold_in(base, jnp.uint32(data)))
        )
    for num in (2, 3):
        want = [tuple(int(w) for w in row) for row in _words(jax.random.split(base, num))]
        assert prng.split(prng.key(seed), num) == want


@pytest.mark.parametrize("maxval", MAXVALS)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_on_the_pool_branch_stream_bit_equal(seed, maxval):
    """``randint(_pair_key(seed, step, 0, TAG_POOL_BRANCH), (), 0, maxval)``
    — the random schedule's draw — over steps 0…2000."""
    tag = ref_tags.TAG_POOL_BRANCH
    want = np.asarray(
        jax.vmap(
            lambda s: jax.random.randint(
                ref_schedules._pair_key(seed, s, 0, tag), (), 0, maxval
            )
        )(jnp.asarray(STEPS, jnp.int32))
    )
    got = np.array(
        [prng.randint(schedules._pair_key(seed, int(s), 0, tag), 0, maxval) for s in STEPS]
    )
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < maxval


@pytest.mark.parametrize("span", [(0, 2**20), (-5, 7), (3, 3), (9, 2), (0, 2**31 - 1)])
def test_randint_spans_bit_equal(span):
    lo, hi = span
    for seed in (0, 7):
        for data in range(20):
            k = prng.fold_in(prng.key(seed), data)
            want = int(jax.random.randint(jax.random.fold_in(jax.random.key(seed), data), (), lo, hi))
            assert prng.randint(k, lo, hi) == want


@pytest.mark.parametrize("mode", ["pairwise", "pull"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_random_schedule_branch_equal(n, mode):
    ref = ref_schedules.build_schedule(ref_config(n, schedule="random", pool_size=16, mode=mode))
    port = schedules.build_schedule(make_local_config(n, schedule="random", pool_size=16, mode=mode))
    np.testing.assert_array_equal(port.pool, ref.pool)
    assert not port.periodic and port.pool_size == 16
    got = [port.branch(step) for step in range(500)]
    assert got == [ref.branch(step) for step in range(500)]
    assert len(set(got)) > 8  # drawn, not cycled


@pytest.mark.parametrize(
    "kw",
    [
        dict(fetch_probability=0.5),
        dict(drop_probability=0.1),
        dict(wire_dtype="int8"),
    ],
)
def test_draws_not_ported_still_raise(kw):
    with pytest.raises(NotImplementedError, match="threefry"):
        schedules.build_schedule(make_local_config(4, schedule="random", **kw))


def test_tag_registry_is_the_reference_copy():
    names = [n for n in dir(ref_tags) if n.isupper()]
    assert names == [n for n in dir(tags) if n.isupper()]
    for name in names:
        assert getattr(tags, name) == getattr(ref_tags, name)
    assert tags._TAG_REGISTRY == ref_tags._TAG_REGISTRY
