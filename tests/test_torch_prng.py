"""The port's threefry against ``jax.random``.

``dpwa_tpu_torch.utils.prng`` must give the installed jax's default draws
(threefry2x32, partitionable bit generation) bit for bit: ``key``,
``fold_in``, ``split``, ``randint``, and through them the random schedule's
per-step pool row; the tensor draws ``random_bits_tensor`` and ``uniform``
too.  ``normal`` and ``truncated_normal`` go through XLA's float32 erfinv
and log1p, ported: each value within 2 float32 ulps of jax's, and at least
95 % of them bit-equal.  Each test records the jax version it compared
against.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu.utils import tags as ref_tags
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.parallel import schedules
from dpwa_tpu_torch.utils import flax_rng, prng, tags

SEEDS = [0, 1, 2**31 - 1]
SHAPES = [(), (7,), (3, 5, 17), (1000, 37)]
ULP_TOL, BIT_EQUAL_SHARE = 2, 0.95  # normal and truncated_normal against jax
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
    """These settings raised until the participation and fault draws and
    the int8 wire were ported; now they build, and a round's draws are the
    reference's (``tests/test_torch_quantize.py`` holds them bit for bit)."""
    ref = ref_schedules.build_schedule(ref_config(4, schedule="random", **kw))
    port = schedules.build_schedule(make_local_config(4, schedule="random", **kw))
    for step in range(20):
        assert [port.participates(step, i) for i in range(4)] == [
            ref.participates(step, i) for i in range(4)
        ]


def test_tag_registry_is_the_reference_copy():
    names = [n for n in dir(ref_tags) if n.isupper()]
    assert names == [n for n in dir(tags) if n.isupper()]
    for name in names:
        assert getattr(tags, name) == getattr(ref_tags, name)
    assert tags._TAG_REGISTRY == ref_tags._TAG_REGISTRY


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a − b| in float32 ulps (the distance between their bit patterns on
    a line where +0 and −0 meet)."""
    ai, bi = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ai = np.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = np.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return np.abs(ai - bi)


def assert_close_draws(got: np.ndarray, want: np.ndarray) -> None:
    d = ulp_distance(got, want)
    assert d.max() <= ULP_TOL, int(d.max())
    assert (d == 0).mean() >= BIT_EQUAL_SHARE, float((d == 0).mean())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_bit_equal(seed, shape):
    jk, k = jax.random.fold_in(jax.random.key(seed), 3), prng.fold_in(prng.key(seed), 3)
    want = np.asarray(jax.random.bits(jk, shape), np.int64)
    np.testing.assert_array_equal(prng.random_bits_tensor(k, shape).numpy(), want)
    for lo, hi in ((0.0, 1.0), (-3.0, 5.0), (prng.ERF_LO_2, prng.ERF_HI_2)):
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        got = prng.uniform(k, shape, lo, hi).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_truncated_normal_within_two_ulps(seed, shape):
    jk, k = jax.random.fold_in(jax.random.key(seed), 5), prng.fold_in(prng.key(seed), 5)
    assert_close_draws(prng.normal(k, shape).numpy(), np.asarray(jax.random.normal(jk, shape)))
    got = prng.truncated_normal(k, shape).numpy()
    assert_close_draws(got, np.asarray(jax.random.truncated_normal(jk, -2, 2, shape)))
    assert got.shape == shape and (np.abs(got) < 2).all()


def test_many_draws_are_mostly_bit_equal():
    """2^18 draws of each: the share that is bit-equal, over enough values
    to see XLA's log1p and erfinv rounding where the port's differs."""
    jk, k = jax.random.key(0), prng.key(0)
    for got, want in (
        (prng.normal(k, (2**18,)), jax.random.normal(jk, (2**18,))),
        (prng.truncated_normal(k, (2**18,)), jax.random.truncated_normal(jk, -2, 2, (2**18,))),
    ):
        assert_close_draws(got.numpy(), np.asarray(want))


def test_erfinv_matches_xla_over_its_domain():
    """erfinv on a grid over (−1, 1), both ends and the branch point of its
    two polynomials (w = 5, |x| ≈ 0.99664), and ±1 → ±inf."""
    from jax._src.lax import special as lax_special

    x = np.concatenate([
        np.linspace(-1, 1, 200001, dtype=np.float32)[1:-1],
        np.float32([0.0, -0.0, 0.99664, -0.99664, 0.9999999, 1e-30, -1e-7]),
    ])
    want = np.asarray(jax.jit(lax_special.erf_inv)(x))
    assert_close_draws(prng.erfinv(torch.from_numpy(x)).numpy(), want)
    ends = prng.erfinv(torch.tensor([1.0, -1.0])).tolist()
    assert ends == [float("inf"), float("-inf")]


def test_erf_literals_bit_equal_to_jax():
    """The ends of truncated_normal's uniform, erf(∓2/√2) in float32 as
    jax computes them inside ``truncated_normal``."""
    from jax._src.lax import special as lax_special

    sqrt2 = np.float32(np.sqrt(2))
    for end, literal in ((-2.0, prng.ERF_LO_2), (2.0, prng.ERF_HI_2)):
        want = np.float32(jax.jit(lambda e: lax_special.erf(e / sqrt2))(jnp.float32(end)))
        assert np.float32(literal).view(np.uint32) == want.view(np.uint32)
    assert np.float32(prng.SQRT2) == sqrt2


@pytest.mark.parametrize("chunk", [1000, 4096])
def test_draws_do_not_depend_on_the_chunk_size(monkeypatch, chunk):
    k = prng.key(11)
    whole = [prng.random_bits_tensor(k, (9001,)), prng.truncated_normal(k, (9001,))]
    monkeypatch.setattr(prng, "CHUNK", chunk)
    parts = [prng.random_bits_tensor(k, (9001,)), prng.truncated_normal(k, (9001,))]
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_tensor_cipher_matches_the_scalar_cipher():
    """The tensor threefry on counters with a non-zero high word (the
    flat index of a draw beyond 2^32) against the scalar one."""
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 2**32, 64, dtype=np.int64)
    lo = rng.integers(0, 2**32, 64, dtype=np.int64)
    for seed in SEEDS:
        k = prng.key(seed)
        got = prng._threefry_tensor(k, torch.from_numpy(hi.copy()), torch.from_numpy(lo.copy()))
        want = [a ^ b for a, b in (prng.threefry2x32(k, (int(h), int(l))) for h, l in zip(hi, lo))]
        assert got.tolist() == want


@pytest.mark.parametrize("data", [
    (), ("params",), ("layer_0", "attn", "wq", 1), ("BasicBlock_3", "Conv_2", 1),
    ("embed", 1), ("x", 0, 255, 256, 70000), ("ünïcode", 2**40),
])
def test_fold_in_static_matches_flax(data):
    from flax.core.scope import _fold_in_static

    want = tuple(int(w) for w in _words(_fold_in_static(jax.random.key(7), data)))
    assert flax_rng.fold_in_static(prng.key(7), data) == want


@pytest.mark.parametrize("shape,axes", [
    ((3, 3, 16, 32), {}), ((64, 10), {}), ((256, 64), {"out_axis": 0}),
    ((128256, 4096), {"out_axis": 0}), ((4096, 14336), {}), ((7, 5, 3), {"in_axis": 0}),
])
def test_compute_fans_matches_jax(shape, axes):
    from jax._src.nn.initializers import _compute_fans

    assert flax_rng.compute_fans(shape, **axes) == _compute_fans(shape, **axes)


@pytest.mark.parametrize("init", ["lecun_normal", "normal", "embed_normal"])
@pytest.mark.parametrize("shape", [(64, 10), (3, 3, 16, 32), (256, 64)])
def test_initialisers_match_flax(init, shape):
    """Each initialiser against the Flax one it ports, on one key."""
    import flax.linen as fnn

    ref = {
        "lecun_normal": fnn.initializers.lecun_normal(),
        "normal": fnn.initializers.normal(stddev=0.02),
        "embed_normal": fnn.initializers.variance_scaling(1.0, "fan_in", "normal", out_axis=0),
    }[init]
    want = np.asarray(ref(jax.random.key(3), shape, jnp.float32))
    k = prng.key(3)
    got = {
        "lecun_normal": lambda: flax_rng.lecun_normal(k, shape),
        "normal": lambda: flax_rng.normal(k, shape, 0.02),
        "embed_normal": lambda: flax_rng.embed_normal(k, shape),
    }[init]().numpy()
    assert_close_draws(got, want)
