"""BatchNorm's running statistics in the port against the reference.

Mirrors ``tests/test_batchnorm_state.py``: the same Flax parameters and
statistics (carried by ``dpwa_tpu_torch.convert``) and the same numpy
batches go to both packages, on the CPU.

- ResNet-8 ``norm_type="batch"``: logits in training and evaluation within
  rtol 1e-4 / atol 1e-5 (the float32 logits tolerance of
  ``tests/test_torch_resnet.py``), the updated ``batch_stats`` within
  rtol 1e-5 / atol 1e-6 (XLA contracts ``0.9·old + 0.1·batch`` into an
  FMA on some elements; two roundings here).
- The stacked exchange over the parameters and the statistics together
  (one buffer, one launch) is bit-equal to the reference's exchange of the
  tuple ``(params, model_state)`` on the f32, bf16 and int8 wires, with an
  exchange filter and at α ≠ 0.5.
- Three stacked ``with_state`` steps of 4 peers, with and without overlap,
  against the reference's: losses rtol 1e-5, parameters rtol 1e-4 / atol
  1e-6 (the stacked step tolerances of ``tests/test_torch_stacked.py``),
  statistics rtol 1e-5 / atol 1e-6.
- The sp ``with_state`` step against ``make_gossip_sp_train_step_with_state``
  on the 8-device CPU mesh: losses rtol 2e-4 / atol 2e-5, parameters and
  statistics rtol 1e-4 / atol 1e-5 (``tests/test_sp_train.py``'s own
  bounds for that step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.interpolation import PeerMeta as RefMeta
from dpwa_tpu.models.resnet import CifarResNet as RefResNet
from dpwa_tpu.parallel import stacked as ref_stacked
from dpwa_tpu.parallel.ici import IciTransport
from dpwa_tpu.train import init_params_per_peer as ref_init_per_peer
from dpwa_tpu.utils.pytree import combine as ref_combine, partition as ref_partition
from dpwa_tpu.train_sp import (
    init_gossip_sp_state as ref_init_sp_state,
    make_gossip_sp_train_step_with_state as ref_make_sp_step,
    make_sp_mesh,
    sp_batch_sharding,
)
from dpwa_tpu_torch import convert, train_sp
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.interpolation import PeerMeta
from dpwa_tpu_torch.models import resnet
from dpwa_tpu_torch.ops import merge
from dpwa_tpu_torch.optim import sgd
from dpwa_tpu_torch.parallel import stacked
from dpwa_tpu_torch.train import softmax_cross_entropy_with_integer_labels
from dpwa_tpu_torch.utils.pytree import Leaves, joint_flat

N = 4


def _tensors(named):
    return {k: torch.from_numpy(np.array(v)) for k, v in named.items()}


def _ref_resnet8(n=N, hw=8, seed=0):
    """The reference's per-peer ResNet-8 (BatchNorm) variables, stacked."""
    model = RefResNet(depth=8, norm_type="batch")
    variables = ref_init_per_peer(
        lambda k: model.init(k, jnp.zeros((1, hw, hw, 3))), jax.random.key(seed), n
    )
    return model, jax.tree.map(np.asarray, variables)


def _shifted_batches(steps, n=N, b=4, hw=8, seed=0):
    """Each peer's inputs offset by its index, so the statistics diverge
    and the exchange visibly mixes them (as the reference's test does)."""
    rng = np.random.default_rng(seed)
    shifts = np.arange(n, dtype=np.float32)[:, None, None, None, None]
    return [
        (rng.random((n, b, hw, hw, 3), np.float32) + shifts,
         rng.integers(0, 10, (n, b)).astype(np.int32))
        for _ in range(steps)
    ]


def test_resnet8_batchnorm_logits_and_stats_match_flax():
    model = RefResNet(depth=8, norm_type="batch")
    variables = jax.tree.map(np.asarray, model.init(jax.random.key(0), jnp.zeros((2, 8, 8, 3))))
    rng = np.random.default_rng(0)
    # Running statistics away from their init, so evaluation reads them.
    stats = jax.tree.map(lambda a: a + rng.random(a.shape).astype(np.float32),
                         variables["batch_stats"])
    x = rng.random((4, 8, 8, 3), np.float32) + 1.0
    ref_vars = {"params": variables["params"], "batch_stats": stats}
    want, updated = model.apply(ref_vars, jnp.asarray(x), mutable=["batch_stats"])
    want_eval = model.apply(ref_vars, jnp.asarray(x), train=False)

    port = resnet.CifarResNet(depth=8, norm_type="batch")
    params = _tensors(convert.flax_to_torch(variables))
    port_stats = _tensors(convert.flax_to_torch({"batch_stats": stats}, collection="batch_stats"))
    assert set(params) == {k for k, _ in port.named_parameters()}
    assert set(port_stats) == set(resnet.batch_stats(port)) == {k for k, _ in port.named_buffers()}
    got, new = resnet.apply_batch_norm(port, params, port_stats, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    want_new = convert.flax_to_torch(jax.tree.map(np.asarray, updated), collection="batch_stats")
    assert set(new) == set(want_new)
    for name, value in new.items():
        np.testing.assert_allclose(value.detach().numpy(), want_new[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    got_eval, same = resnet.apply_batch_norm(port, params, port_stats, torch.from_numpy(x),
                                             train=False)
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(want_eval),
                               rtol=1e-4, atol=1e-5)
    assert all(torch.equal(same[k], port_stats[k]) for k in port_stats)
    # Flax's init: means 0, variances 1; the model alone refuses to run.
    init = convert.flax_to_torch({"batch_stats": variables["batch_stats"]},
                                 collection="batch_stats")
    assert all(torch.equal(v, torch.from_numpy(init[k])) for k, v in resnet.batch_stats(port).items())
    with pytest.raises(RuntimeError, match="apply_batch_norm"):
        port(torch.from_numpy(x))
    back = convert.torch_to_flax({k: v.numpy() for k, v in port_stats.items()},
                                 collection="batch_stats")
    jax.tree.map(np.testing.assert_array_equal, back, {"batch_stats": stats})


def _by_name(tree):
    """``{dotted key path: array}`` in the reference's own layout (kernels
    HWIO): the int8 wire quantizes each leaf in chunks of its flattened
    elements, so a layout change would move the draws."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(k.key) for k in path): torch.from_numpy(np.array(v)) for path, v in flat}


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_exchange_with_state_bit_equal_to_reference_tuple(wire):
    """Parameters and statistics merged in one pass over their shared
    buffer, the parameters filtered, against the reference's exchange of
    ``(selected params, model_state)``: bit for bit, at α ≠ 0.5 (the int8
    wire's draws keyed by the leaves' places in that tuple)."""
    n = 8
    ref_filter = lambda path: "BasicBlock_0" in path or "Dense_0" in path
    _, variables = _ref_resnet8(n, seed=3)
    rng = np.random.default_rng(3)
    noisy = lambda tree: jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape)).astype(np.float32), tree)
    params, stats = noisy(variables["params"]), noisy(variables["batch_stats"])
    clock = rng.random(n).astype(np.float32) * 5
    loss = rng.random(n).astype(np.float32) * 3
    kw = dict(schedule="exponential", wire_dtype=wire, interpolation="constant", factor=0.3)
    ref_t = ref_stacked.StackedTransport(ref_config(n, **kw))
    sel, rest = ref_partition(params, ref_filter)  # by key path
    (merged_sel, merged_stats), _ = ref_t.exchange(
        (sel, stats), RefMeta(jnp.asarray(clock), jnp.asarray(loss)), 5)

    t = stacked.StackedTransport(make_local_config(n, **kw), device="cpu")
    state = stacked.init_stacked_state(_by_name(params), sgd(0.1), t, _by_name(stats))
    columns, leaves = stacked._state_columns(state.params, state.model_state, ref_filter)
    t.exchange(joint_flat(state.params, state.model_state),
               PeerMeta(torch.from_numpy(clock), torch.from_numpy(loss)), 5, columns,
               leaves if wire == "int8" else None)
    for holder, tree in ((state.params, ref_combine(merged_sel, rest)), (state.model_state, merged_stats)):
        want = _by_name(tree)
        assert set(want) == set(holder.names)
        for name, view in holder.views().items():
            np.testing.assert_array_equal(view.numpy(), want[name].numpy(), err_msg=name)


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_exchange_with_state_in_own_layout_bit_equal_to_reference_tuple(wire):
    """The same exchange in the port's own layout (conv kernels OIHW, the
    Dense kernel ``[out, in]``), the buffer told each kernel's axes to the
    reference's layout: bit for bit against the reference's, the int8
    wire's chunks holding the reference's elements.  Without the axes the
    int8 wire's chunks hold other elements and the merge misses."""
    n = 8
    ref_filter = lambda path: "BasicBlock_0" in path or "Dense_0" in path
    _, variables = _ref_resnet8(n, seed=4)
    rng = np.random.default_rng(4)
    noisy = lambda tree: jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape)).astype(np.float32), tree)
    params, stats = noisy(variables["params"]), noisy(variables["batch_stats"])
    clock = rng.random(n).astype(np.float32) * 5
    loss = rng.random(n).astype(np.float32) * 3
    kw = dict(schedule="exponential", wire_dtype=wire, interpolation="loss", factor=0.9)
    ref_t = ref_stacked.StackedTransport(ref_config(n, **kw))
    sel, rest = ref_partition(params, ref_filter)
    (merged_sel, merged_stats), _ = ref_t.exchange(
        (sel, stats), RefMeta(jnp.asarray(clock), jnp.asarray(loss)), 5)
    want = convert.flax_to_torch(ref_combine(merged_sel, rest), stacked=True)
    want_stats = convert.flax_to_torch(merged_stats, stacked=True)

    own = _tensors(convert.flax_to_torch(params, stacked=True))
    axes = convert.reference_axes({k: v.shape[1:] for k, v in own.items()})
    assert len(axes) == 10  # 9 convs and the Dense kernel
    for given in (axes, None):
        t = stacked.StackedTransport(make_local_config(n, **kw), device="cpu")
        state = stacked.init_stacked_state(
            Leaves(own, given), sgd(0.1), t, _tensors(convert.flax_to_torch(stats, stacked=True)))
        columns, leaves = stacked._state_columns(state.params, state.model_state, ref_filter)
        t.exchange(joint_flat(state.params, state.model_state),
                   PeerMeta(torch.from_numpy(clock), torch.from_numpy(loss)), 5, columns,
                   leaves if wire == "int8" else None)
        equal = all(
            np.array_equal(view.numpy(), expected[name])
            for holder, expected in ((state.params, want), (state.model_state, want_stats))
            for name, view in holder.views().items()
        )
        assert equal == (given is not None or wire != "int8"), (wire, given is None)


@pytest.mark.parametrize("overlap", [False, True])
def test_stacked_with_state_steps_match_reference(overlap):
    model, variables = _ref_resnet8()
    batches = _shifted_batches(3)
    kw = dict(schedule="ring", interpolation="loss", factor=0.9)
    ref_t = ref_stacked.StackedTransport(ref_config(N, **kw))
    ref_opt = optax.sgd(0.05, momentum=0.9)

    def ref_loss(params, model_state, batch):
        logits, updated = model.apply(
            {"params": params, "batch_stats": model_state}, batch[0], mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean()
        return loss, updated["batch_stats"]

    ref_step = ref_stacked.make_stacked_train_step(
        ref_loss, ref_opt, ref_t, with_state=True, overlap=overlap)
    ref_state = ref_stacked.init_stacked_state(
        variables["params"], ref_opt, ref_t, stacked_model_state=variables["batch_stats"])

    port = resnet.CifarResNet(depth=8, norm_type="batch")
    t = stacked.StackedTransport(make_local_config(N, **kw), device="cpu")
    opt = sgd(0.05, momentum=0.9)

    def loss_fn(params, model_state, batch):
        logits, new = resnet.apply_batch_norm(port, params, model_state, batch[0])
        return softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean(), new

    step = stacked.make_stacked_train_step(loss_fn, opt, t, with_state=True, overlap=overlap)
    state = stacked.init_stacked_state(
        _tensors(convert.flax_to_torch(variables, stacked=True)), opt, t,
        _tensors(convert.flax_to_torch(variables, stacked=True, collection="batch_stats")),
    )
    init_stats = {k: v.clone() for k, v in state.model_state.views().items()}
    merge.reset_launch_counts()
    for x, y in batches:
        ref_state, ref_losses, _ = ref_step(ref_state, (jnp.asarray(x), jnp.asarray(y)))
        state, losses, info = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-5)
        assert bool(info.participated.all())
    assert merge.pair_merge_.launches == 0  # CPU tensors take the plain version
    got = convert.flax_to_torch({k: v.numpy() for k, v in state.params.views().items()})
    want = convert.flax_to_torch(jax.tree.map(np.asarray, ref_state.params), stacked=True)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-6, err_msg=name)
    want_s = convert.flax_to_torch({"batch_stats": jax.tree.map(np.asarray, ref_state.model_state)},
                                   stacked=True, collection="batch_stats")
    for name, view in state.model_state.views().items():
        np.testing.assert_allclose(view.numpy(), want_s[name], rtol=1e-5, atol=1e-6, err_msg=name)
        assert not torch.equal(view, init_stats[name])  # the statistics moved


SP, V, D, B, T = 4, 64, 16, 2, 16


@pytest.mark.parametrize("overlap", [False, True])
def test_sp_with_state_step_matches_reference(overlap):
    """Each sp rank's statistics of its own block, averaged over the ranks
    and merged with the parameters: the port's virtual axis against the
    reference's ``(peers, sp)`` mesh, three steps."""
    n = 2
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, V, (n, B, T + 1)).astype(np.int32)
    inputs, targets = tokens[..., :-1], tokens[..., 1:]
    w0 = (rng.standard_normal((V, D)) * 0.05).astype(np.float32)
    stacked_w = np.broadcast_to(w0, (n, V, D)).copy()
    kw = dict(schedule="ring", interpolation="loss", factor=0.9)

    ref_cfg = ref_config(n, **kw)
    mesh = make_sp_mesh(ref_cfg, SP)
    ref_t = IciTransport(ref_cfg, mesh=mesh)

    def ref_loss(params, model_state, batch):
        x, y = batch
        h = params["w"][x]
        losses = optax.softmax_cross_entropy_with_integer_labels(h @ params["w"].T, y)
        new = {"h_mean": 0.9 * model_state["h_mean"] + 0.1 * h.mean((0, 1))}
        return (losses.sum(), jnp.float32(losses.size)), new

    ref_step = ref_make_sp_step(ref_loss, optax.sgd(0.1), ref_t, overlap=overlap)
    ref_state = ref_init_sp_state({"w": jnp.asarray(stacked_w)}, optax.sgd(0.1), ref_t,
                                  {"h_mean": jnp.zeros((n, D))})

    t = stacked.StackedTransport(make_local_config(n, **kw), device="cpu")

    def loss_fn(params, model_state, batch):
        x, y = batch
        h = params["w"][x.long()]  # [B, T, D], the whole sequence
        losses = softmax_cross_entropy_with_integer_labels(h @ params["w"].T, y)
        # Rank r's block is T/sp consecutive tokens: its mean over (B, block).
        block_means = h.reshape(B, SP, T // SP, D).mean(dim=(0, 2))  # [sp, D]
        new = {"h_mean": 0.9 * model_state["h_mean"] + 0.1 * block_means}
        return (losses.sum(), torch.tensor(float(losses.numel()))), new

    step = train_sp.make_gossip_sp_train_step_with_state(loss_fn, sgd(0.1), t, overlap=overlap,
                                                          sp=SP)
    state = train_sp.init_gossip_sp_state({"w": torch.from_numpy(stacked_w)}, sgd(0.1), t,
                                          {"h_mean": torch.zeros(n, D)})
    sh = sp_batch_sharding(mesh)
    for _ in range(3):
        ref_state, ref_losses, _ = ref_step(
            ref_state, (jax.device_put(inputs, sh), jax.device_put(targets, sh)))
        state, losses, _ = step(state, (torch.from_numpy(inputs), torch.from_numpy(targets)))
        np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(state.params.views()["w"].numpy(), np.asarray(ref_state.params["w"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(state.model_state.views()["h_mean"].numpy(),
                               np.asarray(ref_state.model_state["h_mean"]), rtol=1e-4, atol=1e-5)
