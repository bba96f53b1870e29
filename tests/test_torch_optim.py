"""The port's optimizers against optax.

``Adam`` against ``optax.adam`` over five steps of random gradients
(updates and moments at rtol 1e-6: both compute the same float32 formulas,
in another order); ``AdamW`` against ``optax.adamw`` as the reference's
train step runs it, compiled, over three steps (updates within 1e-6·lr,
moments within 1e-6 of their largest value: XLA fuses Adam's moment
updates, which moves a moment that nearly cancels far in relative terms),
and its decay term bit for bit (XLA contracts ``u + wd·p`` into one fused
multiply-add; two roundings miss on many elements); the LoRA-masked
optimizer against the reference's
``lora_optimizer(optax.adam)``: exact zeros (no state, no update) on the
frozen leaves, optax's updates on the rest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from dpwa_tpu.models.llama import lora_optimizer as ref_lora_optimizer
from dpwa_tpu_torch.models.llama import lora_filter
import pytest

from dpwa_tpu_torch.optim import adam, adamw, lora_optimizer
from dpwa_tpu_torch.utils.pytree import FlatParams


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    n, p = 3, 257
    x = rng.standard_normal((n, p)).astype(np.float32)
    ref = optax.adam(1e-3)
    ref_state = jax.vmap(ref.init)(jnp.asarray(x))
    opt = adam(1e-3)
    state = opt.init(torch.from_numpy(x))
    for step in range(5):
        g = (rng.standard_normal((n, p)) * 10.0 ** rng.integers(-4, 2, (n, p))).astype(np.float32)
        want, ref_state = jax.vmap(ref.update)(jnp.asarray(g), ref_state)
        got = opt.update_(torch.from_numpy(g), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
        np.testing.assert_allclose(state.mu.numpy(), np.asarray(ref_state[0].mu), rtol=1e-6)
        np.testing.assert_allclose(state.nu.numpy(), np.asarray(ref_state[0].nu), rtol=1e-6)
        assert state.count == int(ref_state[0].count[0]) == step + 1


@pytest.mark.parametrize("wd", [1e-4, 0.3])
def test_adamw_matches_compiled_optax(wd):
    rng = np.random.default_rng(2)
    n, p, lr = 3, 4099, 1e-3
    x = rng.standard_normal((n, p)).astype(np.float32)
    ref = optax.adamw(lr, weight_decay=wd)
    ref_update = jax.jit(jax.vmap(ref.update))
    ref_state = jax.vmap(ref.init)(jnp.asarray(x))
    opt = adamw(lr, weight_decay=wd)
    state = opt.init(torch.from_numpy(x))
    for step in range(3):
        g = (rng.standard_normal((n, p)) * 10.0 ** rng.integers(-4, 2, (n, p))).astype(np.float32)
        want, ref_state = ref_update(jnp.asarray(g), ref_state, jnp.asarray(x))
        got = opt.update_(torch.from_numpy(g), state, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * lr)
        for ours, theirs in ((state.mu, ref_state[0].mu), (state.nu, ref_state[0].nu)):
            theirs = np.asarray(theirs)
            assert np.abs(ours.numpy() - theirs).max() <= 1e-6 * np.abs(theirs).max()
        assert state.count == int(ref_state[0].count[0]) == step + 1
    with pytest.raises(ValueError, match="parameters"):
        opt.update_(torch.from_numpy(g), state)

    decay = jax.jit(jax.vmap(optax.add_decayed_weights(wd).update))
    u = rng.standard_normal((n, p)).astype(np.float32)
    want, _ = decay(jnp.asarray(u), optax.EmptyState(), jnp.asarray(x))
    got = opt.decayed_(torch.from_numpy(u.copy()), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    two_roundings = torch.from_numpy(u) + torch.from_numpy(x) * wd
    assert (two_roundings.numpy() != np.asarray(want)).any()


def test_lora_masked_adam_matches_reference():
    rng = np.random.default_rng(1)
    n = 2
    shapes = {
        "layer_0.attn.wq.kernel": (6, 4),
        "layer_0.attn.wq.lora_a": (6, 2),
        "layer_0.attn.wq.lora_b": (2, 4),
        "layer_0.mlp_norm.scale": (6,),
        "layer_1.attn.wq.lora_a": (6, 2),
    }
    params = {k: rng.standard_normal((n, *s)).astype(np.float32) for k, s in shapes.items()}

    def nest(flat):
        out = {}
        for name, v in flat.items():
            node = out
            *parents, leaf = name.split(".")
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = jnp.asarray(v)
        return {"params": out}

    ref = ref_lora_optimizer(optax.adam(1e-2), jax.tree.map(lambda v: v[0], nest(params)))
    ref_state = jax.vmap(ref.init)(nest(params))

    flat = FlatParams.stack({k: torch.from_numpy(v) for k, v in params.items()}, first=lora_filter)
    opt = lora_optimizer(adam(1e-2), lora_filter)
    state = opt.init(flat.pack(flat.views(), lora_filter))
    assert state.mu.shape == (n, 6 * 2 + 2 * 4 + 6 * 2)
    for _ in range(4):
        grads = {k: rng.standard_normal((n, *s)).astype(np.float32) for k, s in shapes.items()}
        ref_updates, ref_state = jax.vmap(ref.update)(nest(grads), ref_state)
        updates = opt.update_(
            flat.pack({k: torch.from_numpy(v) for k, v in grads.items()}, lora_filter), state
        )
        before = {k: v.clone() for k, v in flat.views().items()}
        flat.add_(updates, lora_filter)
        for name, view in flat.views().items():
            want = np.asarray(_leaf(ref_updates, name))
            got = (view - before[name]).numpy()
            if lora_filter(name):
                np.testing.assert_allclose(
                    view.numpy(), before[name].numpy() + want, rtol=1e-6, atol=1e-7
                )
            else:
                assert np.all(want == 0.0)  # set_to_zero in the reference
                assert np.all(got == 0.0) and torch.equal(view, before[name])


def _leaf(tree, name):
    node = tree["params"]
    for key in name.split("."):
        node = node[key]
    return node
