"""The port's BERT MLM (BASELINE config 4) against the Flax reference.

- Leaves: ``bert_base_config`` has 202 leaves and 132,953,658 parameters
  with the reference's names and shapes (``jax.eval_shape`` of its init);
  ``convert`` carries them across and back exactly, with or without a
  leading peer axis.
- Init from ``prng.key(0)`` against ``model.init(key(0), …)``, at the tiny
  config and at one layer of d 768 (DenseGeneral's flattened fans): every
  drawn leaf within 2 float32 ulps and at least 95 % bit-equal, biases and
  scales exact, and each leaf's key bit-equal (Flax's initialiser on the
  port's key gives Flax's leaf bit for bit).  ``stack_params`` gives every
  peer that one init.
- Logits and ``mlm_loss_fn`` within rtol 1e-4 / atol 1e-5 (with and
  without an attention mask); LayerNorm's fast variance against Flax's
  LayerNorm, where PyTorch's two-pass ``layer_norm`` lands far off.
- The bf16 model against the reference's bf16 model: the logits' gap
  within twice the reference's own bf16 rounding (its bf16 against its
  float32 logits), and the port's bf16 really rounding.
- Four hierarchical stacked steps (three intra-group, one inter-group) of
  8 tiny peers in 2 groups of 4 with AdamW, as the reference example runs
  them on ``dpwa_tpu.parallel.stacked``, on the f32 and the int8 wire:
  the port's step with losses within rtol 1e-5, parameters within rtol
  1e-4 / atol 1e-6 (the attention's key biases, whose gradient is rounding
  noise in both packages, within Adam's step bound) and partners
  bit-equal; the port's example with the same per-step losses and
  partners.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.models import bert as ref_bert
from dpwa_tpu.parallel import stacked as ref_stacked
from dpwa_tpu.train import stack_params as ref_stack_params
from dpwa_tpu_torch import convert
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.examples import bert as bert_example
from dpwa_tpu_torch.models import bert
from dpwa_tpu_torch.optim import adamw
from dpwa_tpu_torch.parallel import stacked
from dpwa_tpu_torch.train import stack_params
from dpwa_tpu_torch.utils import flax_rng, prng
from dpwa_tpu_torch.utils.pytree import leaf_order

# name: (reference config, T); "wide" is one layer at BERT-base's width.
CONFIGS = {
    "tiny": (ref_bert.bert_tiny_config(), 16),
    "wide": (ref_bert.BertConfig(vocab_size=96, d_model=768, n_layers=1, n_heads=12,
                                 d_ff=128, max_seq_len=32), 32),
}


def _port_config(ref_cfg, dtype=None):
    kw = {f: getattr(ref_cfg, f) for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                                           "d_ff", "max_seq_len")}
    return bert.BertConfig(**kw, **({} if dtype is None else {"dtype": dtype}))


@functools.cache
def _ref_init(ref_cfg, t):
    """The reference's ``model.init(key(0), zeros((1, t)))`` as numpy
    arrays (shared: callers copy before they write)."""
    model = ref_bert.BertMLM(ref_cfg)
    return jax.tree.map(np.asarray, model.init(jax.random.key(0), jnp.zeros((1, t), jnp.int32)))


def _torch(named):
    return {k: torch.from_numpy(v) for k, v in named.items()}


def _tokens(vocab, t, batch=2, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (batch, t)).astype(np.int32)


def _ulp_distance(a, b):
    ai, bi = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    return np.abs(np.where(ai < 0, -(ai & 0x7FFFFFFF), ai) - np.where(bi < 0, -(bi & 0x7FFFFFFF), bi))


def test_base_leaves_names_and_convert_roundtrip():
    ref_cfg = ref_bert.bert_base_config()
    shapes = jax.eval_shape(lambda: ref_bert.BertMLM(ref_cfg).init(
        jax.random.key(0), jnp.zeros((1, 128), jnp.int32)))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    model = bert.BertMLM(bert.bert_base_config())
    got = bert.param_shapes(model)
    assert len(got) == len(leaves) == 202
    assert sum(int(np.prod(s)) for s in got.values()) == 132_953_658
    want = {".".join(str(k.key) for k in path[1:]): leaf.shape for path, leaf in leaves}
    assert got == want
    assert list(want) == leaf_order(got)
    assert got["layer_0.attn.query.kernel"] == (768, 12, 64)
    assert got["layer_0.attn.out.kernel"] == (12, 64, 768)

    variables = _ref_init(*CONFIGS["tiny"])
    for lead in (False, True):
        src = jax.tree.map(lambda v: np.stack([v, v + 1.0]), variables) if lead else variables
        named = convert.flax_bert_to_torch(src)
        assert list(named) == leaf_order(named)
        jax.tree.map(np.testing.assert_array_equal, src, convert.torch_bert_to_flax(named))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_matches_flax_model_init(name):
    ref_cfg, t = CONFIGS[name]
    want = convert.flax_bert_to_torch(_ref_init(ref_cfg, t))
    model = bert.BertMLM(_port_config(ref_cfg))
    key = prng.key(0)
    got = bert.init(model, key)
    assert set(got) == set(want)
    lecun = fnn.initializers.lecun_normal()
    for leaf, value in got.items():
        g, w = value.numpy(), want[leaf]
        assert g.shape == w.shape, leaf
        *path, last = leaf.split(".")
        if last in ("bias", "scale"):
            np.testing.assert_array_equal(g, w)
            continue
        d = _ulp_distance(g, w)
        assert d.max() <= 2 and (d == 0).mean() >= 0.95, (leaf, d.max(), (d == 0).mean())
        # The leaf's key: Flax's own initialiser on it gives Flax's leaf.
        k = jax.random.wrap_key_data(np.asarray(flax_rng.param_key(key, path, 1), np.uint32))
        if last == "kernel":
            n_in = 2 if path[-1] == "out" else 1
            flat = (int(np.prod(w.shape[:n_in])), int(np.prod(w.shape[n_in:])))
            again = lecun(k, flat, jnp.float32).reshape(w.shape)
        elif last == "embedding":
            again = fnn.initializers.variance_scaling(1.0, "fan_in", "normal", out_axis=0)(
                k, w.shape, jnp.float32)
        else:
            assert last == "pos_embed" and path == []
            again = fnn.initializers.normal(0.02)(k, w.shape, jnp.float32)
        np.testing.assert_array_equal(np.asarray(again), w)


def test_stack_params_gives_every_peer_the_one_init():
    ref_cfg, t = CONFIGS["tiny"]
    model = bert.BertMLM(_port_config(ref_cfg))
    one = bert.init(model, prng.key(0))
    flat = stack_params(one, 3, "cpu")
    want = convert.flax_bert_to_torch(
        jax.tree.map(np.asarray, ref_stack_params(_ref_init(ref_cfg, t), 3)))
    views = flat.views()
    assert list(views) == leaf_order(one) and flat.size == sum(v.numel() for v in one.values())
    for name, view in views.items():
        assert torch.equal(view, one[name].expand_as(view)), name
        assert view.shape == want[name].shape
    view = views["pos_embed"]
    view[0].add_(1.0)  # each row is its own copy
    assert torch.equal(view[1], one["pos_embed"])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_and_loss_match_flax(name, masked):
    ref_cfg, t = CONFIGS[name]
    variables = _ref_init(ref_cfg, t)
    rng = np.random.default_rng(3)
    # Perturb every leaf so that biases, scales and every product count.
    variables = jax.tree.map(
        lambda v: (v + rng.normal(0, 0.05, v.shape)).astype(np.float32), variables)
    tokens = _tokens(ref_cfg.vocab_size, t)
    am = None
    if masked:
        am = np.ones((2, t), np.int32)
        am[1, t // 2:] = 0
    ref_model = ref_bert.BertMLM(ref_cfg)
    want = np.asarray(ref_model.apply(
        variables, jnp.asarray(tokens), attention_mask=None if am is None else jnp.asarray(am)))
    model = bert.BertMLM(_port_config(ref_cfg))
    params = _torch(convert.flax_bert_to_torch(variables))
    got = bert.apply(model, params, torch.from_numpy(tokens),
                     None if am is None else torch.from_numpy(am))
    assert got.dtype == torch.float32 and got.shape == (2, t, ref_cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)

    inputs, targets, weights = ref_bert.mlm_mask_batch(
        rng.integers(1, ref_cfg.vocab_size, (2, t)), rng, 0.3)
    want_loss = float(ref_bert.mlm_loss_fn(ref_model)(
        variables, (jnp.asarray(inputs), jnp.asarray(targets), jnp.asarray(weights))))
    got_loss = bert.mlm_loss_fn(model)(
        params, (torch.from_numpy(inputs), torch.from_numpy(targets), torch.from_numpy(weights)))
    np.testing.assert_allclose(float(got_loss), want_loss, rtol=1e-4, atol=1e-5)


def test_mlm_mask_batch_is_the_reference_copy():
    tokens = np.random.default_rng(0).integers(1, 128, (3, 4, 32))
    got = bert.mlm_mask_batch(tokens, np.random.default_rng(5), 0.2)
    want = ref_bert.mlm_mask_batch(tokens, np.random.default_rng(5), 0.2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert bert.MASK_TOKEN == ref_bert.MASK_TOKEN


def test_layernorm_fast_variance_matches_flax():
    """Flax's E[x²] − E[x]² against PyTorch's two-pass ``layer_norm`` on
    rows of 8 integers near 1320: every sum is exact in float32 and a mean
    is a sum over 8, so the statistics do not depend on the order of the
    sums, and the only rounding is E[x]²'s (a 21-bit integer part), which
    moves the variance by up to about 0.06 of its 133.  The port computes
    Flax's form and lands on Flax's output; the two-pass form does not."""
    rng = np.random.default_rng(0)
    x = rng.integers(1300, 1340, (64, 8)).astype(np.float32)
    x[0] = 1317.0  # a constant row: the variance is 0
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    want = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x)))
    xt, st, bt = map(torch.from_numpy, (x, scale, bias))
    got = torch.func.functional_call(
        bert.LayerNorm(8), {"scale": st, "bias": bt}, (xt,)).numpy()
    two_pass = F.layer_norm(xt, (8,), st, bt, eps=1e-6).numpy()
    port_gap, torch_gap = np.abs(got - want).max(), np.abs(two_pass - want).max()
    assert port_gap <= 1e-5, port_gap
    assert torch_gap > 1e-4, torch_gap
    np.testing.assert_array_equal(got[0], bias)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_bf16_logits_match_reference_bf16():
    """``--bf16`` against the reference's bf16 model at one layer of d 768,
    weights carried across: the gap within twice the reference's own bf16
    rounding (its bf16 against its float32 logits), and the port's bf16
    really rounding (its gap to its own float32 logits over a quarter of
    the reference's)."""
    ref_cfg, t = CONFIGS["wide"]
    variables = _ref_init(ref_cfg, t)
    tokens = jnp.asarray(_tokens(ref_cfg.vocab_size, t))
    ref16 = ref_bert.BertMLM(ref_bert.BertConfig(**{
        **{f: getattr(ref_cfg, f) for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                                            "d_ff", "max_seq_len")}, "dtype": jnp.bfloat16}))
    want = np.asarray(ref16.apply(variables, tokens))
    f32 = np.asarray(ref_bert.BertMLM(ref_cfg).apply(variables, tokens))
    params = _torch(convert.flax_bert_to_torch(variables))
    tt = torch.from_numpy(np.array(tokens))
    got = bert.apply(bert.BertMLM(_port_config(ref_cfg, torch.bfloat16)), params, tt)
    port_f32 = bert.apply(bert.BertMLM(_port_config(ref_cfg)), params, tt).numpy()
    assert got.dtype == torch.float32 and want.dtype == np.float32
    got = got.numpy()
    ref_own = np.abs(want - f32).max()
    gap = np.abs(got - want).max()
    assert gap <= 2 * ref_own, (gap, ref_own)
    assert np.abs(got - port_f32).max() > ref_own / 4


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_hierarchical_steps_match_reference(wire):
    """8 tiny peers in 2 groups of 4 (the reference's hierarchical test's
    setting), AdamW at lr 3e-3, batch 4 a peer, T 16: four steps (three
    intra-group slots, then the inter-group one) of the reference example's
    loop (``examples/bert/main.py``: ``stack_params`` of the key-0 init,
    ``optax.adamw``, one fresh batch a step from ``default_rng(0)``) on its
    stacked transport, against the port's stacked step and against
    ``dpwa_tpu_torch.examples.bert``."""
    n, group, batch, t, steps, lr = 8, 4, 4, 16, 4, 3e-3
    mcfg = ref_bert.bert_tiny_config()
    kw = dict(schedule="hierarchical", group_size=group, inter_period=4, wire_dtype=wire)
    ref_t = ref_stacked.StackedTransport(ref_config(n, **kw))
    ref_model = ref_bert.BertMLM(mcfg)
    ref_opt = optax.adamw(lr)
    init = _ref_init(mcfg, t)
    ref_state = ref_stacked.init_stacked_state(
        jax.tree.map(jnp.asarray, ref_stack_params(init, n)), ref_opt, ref_t)
    ref_step = ref_stacked.make_stacked_train_step(ref_bert.mlm_loss_fn(ref_model), ref_opt, ref_t)

    port_t = stacked.StackedTransport(make_local_config(n, **kw), device="cpu")
    model = bert.BertMLM(_port_config(mcfg))
    opt = adamw(lr)
    state = stacked.init_stacked_state(
        stack_params(_torch(convert.flax_bert_to_torch(init)), n, "cpu"), opt, port_t)
    step = stacked.make_stacked_train_step(bert.mlm_loss_fn(model), opt, port_t)
    rng = np.random.default_rng(0)
    V = mcfg.vocab_size
    groups = np.arange(n) // group
    ref_mean, ref_partners = [], []
    for i in range(steps):
        seq = [rng.integers(1, V, (n, batch, 1))]
        for _ in range(t - 1):
            seq.append((2 * seq[-1] + 1) % V)
        data = ref_bert.mlm_mask_batch(np.concatenate(seq, axis=-1), rng)
        ref_state, ref_losses, ref_info = ref_step(ref_state, tuple(map(jnp.asarray, data)))
        state, losses, info = step(state, tuple(map(torch.from_numpy, data)))
        np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-5)
        partner = np.asarray(ref_info.partner)
        np.testing.assert_array_equal(info.partner.numpy(), partner)
        assert ((groups[partner] == groups) == (i % 4 != 3)).all()  # intra, then inter
        ref_mean.append(float(np.asarray(ref_losses).mean()))
        ref_partners.append(partner.tolist())
    want = convert.flax_bert_to_torch(jax.tree.map(np.asarray, ref_state.params))
    start = convert.flax_bert_to_torch(init)
    for name, view in state.params.views().items():
        if name.endswith("attn.key.bias"):
            # Its gradient is 0 in exact arithmetic (it adds one constant to
            # a query's every score, which the softmax cancels), so in both
            # packages Adam steps it by rounding noise: hold only the size
            # of the drift, at most lr·|m̂|/√v̂ ≤ 1.5·lr a step.
            for drift in (view.numpy() - start[name], want[name] - start[name]):
                assert np.abs(drift).max() <= steps * 1.5 * lr, name
            continue
        np.testing.assert_allclose(view.numpy(), want[name], rtol=1e-4, atol=1e-6, err_msg=name)
    moved = max(float(np.abs(want[k][0] - start[k]).max()) for k in start)
    assert moved > 1e-3  # AdamW moved the weights well past the tolerance

    res = bert_example.main([
        "--tiny", "--device", "cpu", "--peers", str(n), "--group-size", str(group),
        "--steps", str(steps), "--batch-size", str(batch), "--seq-len", str(t),
        "--lr", str(lr), "--wire-dtype", wire, "--log-every", "1",
    ])
    np.testing.assert_allclose(res["losses"], ref_mean, rtol=1e-5)
    assert res["partners"] == ref_partners and res["final_step"] == steps
    assert res["params_per_peer"] == sum(v.size for v in start.values())


def test_example_flags_fail_as_the_reference():
    with pytest.raises(SystemExit):
        bert_example.main(["--tiny", "--device", "cpu", "--seq-len", "65"])
    with pytest.raises(NotImplementedError, match="TCP"):
        bert_example.main(["--tiny", "--device", "cpu", "--certify"])
