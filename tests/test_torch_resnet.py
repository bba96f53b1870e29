"""The port's ResNet against the Flax model, with parameters carried across
by ``dpwa_tpu_torch.convert``: logits at batch 2 within rtol 1e-4 / atol
1e-5, and the layer choices that make them match pinned one by one."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dpwa_tpu.models.resnet import CifarResNet as RefResNet
from dpwa_tpu_torch import convert
from dpwa_tpu_torch.models import resnet
from dpwa_tpu_torch.utils import prng
from dpwa_tpu_torch.utils.pytree import FlatParams, leaf_order


def _carry(variables):
    return {
        k: torch.from_numpy(v)
        for k, v in convert.flax_to_torch(jax.tree.map(np.asarray, variables)).items()
    }


@pytest.mark.parametrize("depth", [8, 20])
def test_logits_match_flax(depth):
    ref = RefResNet(depth=depth)
    x = np.random.default_rng(depth).random((2, 32, 32, 3), np.float32)
    variables = ref.init(jax.random.key(depth), jnp.zeros((1, 32, 32, 3)))
    want = np.asarray(ref.apply(variables, jnp.asarray(x)))
    model = resnet.CifarResNet(depth=depth)
    params = _carry(variables)
    assert set(params) == {name for name, _ in model.named_parameters()}
    got = torch.func.functional_call(model, params, (torch.from_numpy(x),))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)


def test_stride2_conv_pads_like_flax_same():
    # SAME on an even size with stride 2 pads (0, 1): torch's symmetric
    # padding=1 would shift every output pixel.
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    flax_conv = fnn.Conv(6, (3, 3), (2, 2), use_bias=False)
    v = flax_conv.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(flax_conv.apply(v, jnp.asarray(x))).transpose(0, 3, 1, 2)
    conv = resnet.Conv(4, 6, 3, strides=2)
    kernel = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = torch.func.functional_call(conv, {"kernel": kernel}, (xt,))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    symmetric = F.conv2d(xt, kernel, stride=2, padding=1).numpy()
    assert np.abs(symmetric - want).max() > 0.1


def test_groupnorm_matches_flax_fast_variance_and_epsilon():
    rng = np.random.default_rng(1)
    # An offset mean, where E[x²] − E[x]² rounds differently from the
    # two-pass variance (a far larger offset makes both forms noise).
    x = (rng.standard_normal((2, 4, 4, 32)) + 2.0).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=None, group_size=16)
    v = gn.init(jax.random.key(0), jnp.asarray(x))
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    want = np.asarray(gn.apply(v, jnp.asarray(x))).transpose(0, 3, 1, 2)
    mod = resnet.GroupNorm(32)
    got = torch.func.functional_call(
        mod, {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
        (torch.from_numpy(x).permute(0, 3, 1, 2),),
    )
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)
    assert mod.epsilon == gn.epsilon == 1e-6


def test_resnet20_size_and_leaf_order_match_flax():
    variables = RefResNet(depth=20).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    paths = [
        "/".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(variables)[0]
    ]
    model = resnet.ResNet20()
    names = leaf_order(name for name, _ in model.named_parameters())
    assert ["params/" + n.replace(".", "/") for n in names] == paths
    flat = FlatParams.stack({k: v[None] for k, v in _carry(variables).items()})
    assert (len(flat.names), flat.size) == (65, 272474)
    assert flat.ld % 32 == 0 and flat.ld >= flat.size


def test_convert_roundtrip_is_exact():
    variables = RefResNet(depth=8).init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))
    back = convert.torch_to_flax({k: v.numpy() for k, v in _carry(variables).items()})
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), variables, back
    )


def test_init_is_seeded_lecun_normal():
    model = resnet.CifarResNet(depth=8)
    a = resnet.init(model, prng.key(0))
    b = resnet.init(model, prng.key(0))
    assert all(torch.equal(a[k], b[k]) for k in a)
    kernel = a["BasicBlock_2.Conv_1.kernel"]  # 64 x 64 x 3 x 3: fan_in 576
    assert abs(float(kernel.std()) - (1 / 576) ** 0.5) < 0.05 * (1 / 576) ** 0.5
    assert float(kernel.abs().max()) <= 2 * (1 / 576) ** 0.5 / 0.87962566103423978
    assert torch.equal(a["GroupNorm_0.scale"], torch.ones(16))
    assert torch.equal(a["Dense_0.bias"], torch.zeros(10))


def test_bf16_compute_knob_keeps_dense_in_f32():
    variables = RefResNet(depth=8).init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    x = torch.from_numpy(np.random.default_rng(2).random((2, 32, 32, 3), np.float32))
    params = _carry(variables)
    f32 = torch.func.functional_call(resnet.CifarResNet(depth=8), params, (x,))
    bf16 = torch.func.functional_call(
        resnet.CifarResNet(depth=8, dtype=torch.bfloat16), params, (x,)
    )
    assert bf16.dtype == torch.float32
    torch.testing.assert_close(bf16, f32, rtol=0.1, atol=0.1)


def test_unported_variants_raise():
    # norm_type="batch" is ported (tests/test_torch_batchnorm.py); an
    # unknown norm raises as the reference's ``_norm`` does.
    with pytest.raises(ValueError, match="unknown norm"):
        resnet.CifarResNet(depth=8, norm_type="layer")
    with pytest.raises(ValueError):
        resnet.CifarResNet(depth=9)


def _ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ai, bi = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    return np.abs(np.where(ai < 0, -(ai & 0x7FFFFFFF), ai) - np.where(bi < 0, -(bi & 0x7FFFFFFF), bi))


@pytest.mark.parametrize("depth,n", [(8, 4), (20, 2)])
def test_init_matches_flax_model_init_per_peer(depth, n):
    """The port's per-peer init from ``prng.key(0)`` against the reference's
    ``init_params_per_peer`` (``jax.vmap(model.init)`` over
    ``jax.random.split(key(0), n)``): every kernel within 2 float32 ulps and
    at least 95 % of its values bit-equal (XLA's erfinv, ported), norm
    scales and biases exact, laid out as the port's OIHW / ``[out, in]``."""
    from dpwa_tpu.train import init_params_per_peer as ref_init_per_peer
    from dpwa_tpu_torch.train import init_params_per_peer

    ref = RefResNet(depth=depth)
    want = convert.flax_to_torch(jax.tree.map(np.asarray, ref_init_per_peer(
        lambda k: ref.init(k, jnp.zeros((1, 32, 32, 3))), jax.random.key(0), n)), stacked=True)
    model = resnet.CifarResNet(depth=depth)
    got = init_params_per_peer(lambda k: resnet.init(model, k), prng.key(0), n, "cpu").views()
    assert list(got) == leaf_order(want)
    for name, value in got.items():
        g, w = value.numpy(), want[name]
        assert g.shape == w.shape, name
        if name.endswith("kernel"):
            d = _ulp_distance(g, w)
            assert d.max() <= 2 and (d == 0).mean() >= 0.95, (name, d.max(), (d == 0).mean())
        else:
            np.testing.assert_array_equal(g, w)


def test_module_starts_from_the_reference_draws():
    """A freshly built module holds ``init(model, prng.key(0))``."""
    model = resnet.CifarResNet(depth=8)
    want = resnet.init(model, prng.key(0))
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name


@pytest.mark.parametrize("depth", [8, 20])
def test_bf16_logits_match_reference_bf16(depth):
    """The bf16 model against the reference's bf16 model, weights carried
    across: the gap within twice the reference's own bf16 rounding (its
    bf16 against its float32 logits), and the port's bf16 really rounding
    (its gap to its own float32 logits over a quarter of that).  Measured
    at seeds 1 and 2: gaps 6.0e-3 / 6.3e-3 (depth 8) and 1.16e-2 / 8.7e-3
    (depth 20), against the reference's own 4.6e-3 / 7.3e-3 and 9.2e-3 /
    1.12e-2: independent bf16 roundings of the same size."""
    variables = RefResNet(depth=depth).init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    x = np.random.default_rng(1).random((4, 32, 32, 3), np.float32)
    want = np.asarray(jax.jit(RefResNet(depth=depth, dtype=jnp.bfloat16).apply)(variables, jnp.asarray(x)))
    ref_f32 = np.asarray(jax.jit(RefResNet(depth=depth).apply)(variables, jnp.asarray(x)))
    params = _carry(variables)
    got = torch.func.functional_call(
        resnet.CifarResNet(depth=depth, dtype=torch.bfloat16), params, (torch.from_numpy(x),)
    ).numpy()
    port_f32 = torch.func.functional_call(
        resnet.CifarResNet(depth=depth), params, (torch.from_numpy(x),)
    ).detach().numpy()
    ref_own = np.abs(want - ref_f32).max()
    assert np.abs(got - want).max() <= 2 * ref_own, (np.abs(got - want).max(), ref_own)
    assert np.abs(got - port_f32).max() > ref_own / 4
