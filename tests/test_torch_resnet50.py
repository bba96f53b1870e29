"""The port's ImageNet ResNet-50 against the Flax model, at 64×64, batch 2.

- Peers 0 and 1's init from ``prng.key(0)`` against the reference's
  ``init_params_per_peer`` over ``model.init``: every kernel within 2
  float32 ulps and at least 95 % of its values bit-equal (the ResNet-20
  test's bound), norm scales and biases exact; 161 leaves carried across
  by ``convert`` and back exactly.
- Logits within rtol 1e-4 / atol 1e-5 (the ResNet-20 test's tolerance).
- Gradients against ``jax.grad``: the Dense head's within 1e-4 normwise
  (max |Δ| over max |want|), and all 161 leaves together within 2e-2 in
  relative L2 norm (measured 1.6e-4 to 5.3e-3 over four peers' weights and
  batches).  At 64×64 the late stages are 2×2, so a leaf's gradient sums a
  few elements, and a ReLU whose input lies within float32 rounding of 0
  opens in one package and not in the other: single elements move by up to
  5 % of their leaf's largest value, in either package against a float64
  gradient, case by case (a float64 check found each package the farther
  one in one of two cases).
- Two stacked SGD steps with 4 peers on the random schedule, from the
  reference's init carried across, against its ``StackedTransport`` step:
  the first step's losses within rtol 1e-5 and the pairings equal; the
  second's losses within rtol 1e-4 (measured 1.7e-5: the first step's
  gradients differ as above) and the parameters' change over the two
  steps within 2e-2 in relative L2 norm.
- The bf16 model against the reference's bf16 model, weights carried
  across: the logits' gap within twice the reference's own bf16 rounding
  (its bf16 against its float32 logits: 0.051 at 64×64; the gap measured
  0.053 to 0.068), and the port's bf16 really rounding (its gap to its own
  float32 logits over a quarter of the reference's).
- The stem's SAME max-pool, alone, against Flax's ``nn.max_pool``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.models.resnet import ResNet50 as RefResNet50
from dpwa_tpu.parallel import stacked as ref_stacked
from dpwa_tpu.train import init_params_per_peer as ref_init_per_peer
from dpwa_tpu_torch import convert
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.models import resnet
from dpwa_tpu_torch.optim import sgd
from dpwa_tpu_torch.parallel import stacked
from dpwa_tpu_torch.train import init_params_per_peer, softmax_cross_entropy_with_integer_labels
from dpwa_tpu_torch.utils import prng
from dpwa_tpu_torch.utils.pytree import leaf_order

HW, PEERS = 64, 4


@pytest.fixture(scope="module")
def ref_init():
    """The reference's per-peer init from key(0) at [PEERS, ...], compiled."""
    model = RefResNet50()
    params = jax.jit(lambda key: ref_init_per_peer(
        lambda k: model.init(k, jnp.zeros((1, HW, HW, 3))), key, PEERS
    ))(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def model():
    """The module for ``functional_call``, built without values."""
    return resnet.ResNet50(device="meta")


def _peer(tree, i):
    return jax.tree.map(lambda v: v[i], tree)


def _carry(variables):
    return {k: torch.from_numpy(v) for k, v in convert.flax_to_torch(variables).items()}


def _ulp_distance(a, b):
    ai, bi = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    return np.abs(np.where(ai < 0, -(ai & 0x7FFFFFFF), ai) - np.where(bi < 0, -(bi & 0x7FFFFFFF), bi))


def _batch(seed, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.random((*lead, 2, HW, HW, 3), np.float32)
    y = rng.integers(0, 1000, (*lead, 2)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("size", [7, 8, 112])
def test_max_pool_same_windows_match_flax(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    x[0, 0, 0, 0] = -1e30  # a corner only the −inf padding can beat
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2), "SAME")).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resnet.max_pool_same(xt)
    np.testing.assert_array_equal(got.numpy(), want)
    if size % 2 == 0:  # torch's symmetric padding moves every window by one
        shifted = F.max_pool2d(xt, 3, 2, padding=1)
        assert shifted.shape == got.shape and not torch.equal(shifted, got)


def test_stem_conv_pads_like_flax_same():
    """7×7 stride 2 on 224 pads (2, 3), not PyTorch's symmetric 3."""
    x = np.random.default_rng(0).standard_normal((1, 224, 224, 3)).astype(np.float32)
    conv = fnn.Conv(8, (7, 7), (2, 2), use_bias=False)
    v = conv.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(conv.apply(v, jnp.asarray(x))).transpose(0, 3, 1, 2)
    kernel = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = torch.func.functional_call(resnet.Conv(3, 8, 7, strides=2), {"kernel": kernel}, (xt,))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)
    assert resnet._same_pads(224, 7, 2) == (2, 3)
    symmetric = F.conv2d(xt, kernel, stride=2, padding=3).numpy()
    assert np.abs(symmetric - want).max() > 0.1


def test_leaves_and_convert_roundtrip(ref_init, model):
    variables = _peer(ref_init, 0)
    paths = [
        "/".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(variables)[0]
    ]
    names = leaf_order(name for name, _ in model.named_parameters())
    assert len(names) == 161 and sum(p.numel() for p in model.parameters()) == 25_557_032
    assert ["params/" + n.replace(".", "/") for n in names] == paths
    carried = convert.flax_to_torch(variables)
    assert set(carried) == set(names)
    for name, p in model.named_parameters():
        assert carried[name].shape == tuple(p.shape), name
    back = convert.torch_to_flax(carried)
    jax.tree.map(np.testing.assert_array_equal, variables, back)


def test_init_matches_flax_model_init_per_peer(ref_init, model):
    """Peers 0 and 1 (peer i's key is ``split(key(0), n)[i]`` for any n)."""
    want = {k: v[:2] for k, v in convert.flax_to_torch(ref_init, stacked=True).items()}
    got = init_params_per_peer(lambda k: resnet.init(model, k), prng.key(0), 2, "cpu").views()
    assert list(got) == leaf_order(want)
    for name, value in got.items():
        g, w = value.numpy(), want[name]
        assert g.shape == w.shape, name
        if name.endswith("kernel"):
            d = _ulp_distance(g, w)
            assert d.max() <= 2 and (d == 0).mean() >= 0.95, (name, d.max(), (d == 0).mean())
        else:
            np.testing.assert_array_equal(g, w)


def _normwise(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_logits_and_grads_match_flax(ref_init, model):
    variables = jax.tree.map(jnp.asarray, _peer(ref_init, 1))
    x, y = _batch(1)
    ref = RefResNet50()

    def ref_loss(p, xx):
        logits = ref.apply(p, xx)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    want_logits = np.asarray(jax.jit(ref.apply)(variables, jnp.asarray(x)))
    want = convert.flax_to_torch(jax.tree.map(np.asarray, jax.jit(jax.grad(ref_loss))(
        variables, jnp.asarray(x))))
    params = _carry(jax.tree.map(np.asarray, variables))
    logits = torch.func.functional_call(model, params, (torch.from_numpy(x),))
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=1e-4, atol=1e-5)

    def loss(p):
        out = torch.func.functional_call(model, p, (torch.from_numpy(x),))
        return softmax_cross_entropy_with_integer_labels(out, torch.from_numpy(y)).mean()

    got = {k: v.numpy() for k, v in torch.func.grad(loss)(params).items()}
    assert set(got) == set(want)
    for name in ("Dense_0.kernel", "Dense_0.bias"):
        assert _normwise(got[name], want[name]) < 1e-4, name
    assert _relative_l2(got, want) < 2e-2


def _relative_l2(got, want):
    num = sum(float(np.sum((np.float64(got[k]) - want[k]) ** 2)) for k in want)
    return (num / sum(float(np.sum(np.float64(want[k]) ** 2)) for k in want)) ** 0.5


def test_two_stacked_steps_match_reference(ref_init, model):
    ref_model = RefResNet50()
    ref_cfg = ref_config(PEERS, schedule="random", pool_size=32)
    ref_t = ref_stacked.StackedTransport(ref_cfg)
    ref_opt = optax.sgd(0.1, momentum=0.9)

    def ref_loss(params, batch):
        x, y = batch
        return optax.softmax_cross_entropy_with_integer_labels(ref_model.apply(params, x), y).mean()

    ref_step = ref_stacked.make_stacked_train_step(ref_loss, ref_opt, ref_t)
    ref_state = ref_stacked.init_stacked_state(jax.tree.map(jnp.asarray, ref_init), ref_opt, ref_t)

    port_t = stacked.StackedTransport(make_local_config(PEERS, schedule="random", pool_size=32),
                                      device="cpu")
    opt = sgd(0.1, momentum=0.9)

    def loss_fn(params, batch):
        x, y = batch
        logits = torch.func.functional_call(model, params, (x,))
        return softmax_cross_entropy_with_integer_labels(logits, y).mean()

    step = stacked.make_stacked_train_step(loss_fn, opt, port_t)
    carried = convert.flax_to_torch(ref_init, stacked=True)
    state = stacked.init_stacked_state(
        {k: torch.from_numpy(v) for k, v in carried.items()}, opt, port_t
    )
    for seed in range(2):
        x, y = _batch(10 + seed, (PEERS,))
        ref_state, ref_losses, ref_info = ref_step(ref_state, (jnp.asarray(x), jnp.asarray(y)))
        state, losses, info = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-5 if seed == 0 else 1e-4)
        np.testing.assert_array_equal(info.partner.numpy(), np.asarray(ref_info.partner))
        assert bool(info.participated.all())
    start = convert.flax_to_torch(ref_init, stacked=True)
    want = convert.flax_to_torch(jax.tree.map(np.asarray, ref_state.params), stacked=True)
    got = {k: v.numpy() for k, v in state.params.views().items()}
    assert _relative_l2({k: got[k] - start[k] for k in got}, {k: want[k] - start[k] for k in got}) < 2e-2


def test_bf16_logits_match_reference_bf16(ref_init, model):
    """The bf16 compute knob against the reference's bf16 model (not only
    against the port's own float32 model): the gap is the two conv
    libraries' float32 accumulation order, rounded to bf16 at every layer."""
    variables = _peer(ref_init, 2)
    x, _ = _batch(2)
    want = np.asarray(jax.jit(RefResNet50(dtype=jnp.bfloat16).apply)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
    f32 = np.asarray(jax.jit(RefResNet50().apply)(jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
    port_f32 = torch.func.functional_call(model, _carry(variables), (torch.from_numpy(x),))
    bf16 = resnet.ResNet50(dtype=torch.bfloat16, device="meta")
    got = torch.func.functional_call(bf16, _carry(variables), (torch.from_numpy(x),))
    assert got.dtype == torch.float32
    ref_own = np.abs(want - f32).max()
    gap = np.abs(got.detach().numpy() - want).max()
    assert gap <= 2 * ref_own, (gap, ref_own)
    assert np.abs(got.detach().numpy() - port_f32.detach().numpy()).max() > ref_own / 4
