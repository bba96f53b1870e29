"""The port's stacked exchange against the reference's, bit for bit, with the
participation and fault draws and on every wire.

``dpwa_tpu.parallel.stacked.stacked_gossip_exchange`` (compiled, as its
transport runs it) and ``dpwa_tpu_torch.parallel.stacked`` take the same
peer-stacked leaves, made with numpy from a seed, under the ring, random
and pull schedules; the f32, bf16 and int8 wires; full participation, and
``fetch_probability`` 0.5 with ``drop_probability`` 0.25; and the loss-based
interpolation, so that α ≠ 0.5 and a wrong fused multiply-add shows.  Rows
hold an inf and a NaN, so what a sat-out or non-participating peer makes of
a partner's non-finite row is compared too.  On the CPU the port runs its
kernels' plain versions.  A LoRA-filtered case on the int8 wire pins the
leaf index that keys each leaf's draws: the leaf's place among the selected
leaves in the reference's flatten order, which the flat buffer's column
order (the LoRA leaves first) must not disturb.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.interpolation import PeerMeta as RefMeta
from dpwa_tpu.parallel import stacked as ref_stacked
from dpwa_tpu.utils.pytree import partition as ref_partition
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.interpolation import PeerMeta
from dpwa_tpu_torch.parallel import stacked
from dpwa_tpu_torch.utils.pytree import FlatParams, Leaves

SHAPES = {"a_kernel": (3, 50), "b_bias": (7,), "c_kernel": (2, 2, 8, 40), "d_scale": (300,)}
SCHEDULES = {
    "ring": dict(schedule="ring"),
    "random": dict(schedule="random", pool_size=8),
    "pull": dict(schedule="ring", mode="pull"),
}
DRAWS = {"full": {}, "partial": dict(fetch_probability=0.5, drop_probability=0.25)}


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    both_nan = np.isnan(a) & np.isnan(b)
    return a.shape == b.shape and bool(np.all((a.view(np.int32) == b.view(np.int32)) | both_nan))


def _tree(n, seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    tree = {k: rng.standard_normal((n, *s)).astype(np.float32) for k, s in shapes.items()}
    first = next(iter(tree))
    tree[first].reshape(n, -1)[1, 3] = np.inf  # a peer ships an inf ...
    tree[first].reshape(n, -1)[n // 2 + 1, 0] = np.nan  # ... and another a NaN
    return tree


def _run(n, kw, tree, steps=4, seed=0):
    """Both exchanges over ``steps`` rounds; yields (round, the reference's
    leaves and info, the port's leaves and info)."""
    ref_t = ref_stacked.StackedTransport(ref_config(n, **kw))
    port_t = stacked.StackedTransport(make_local_config(n, **kw), device="cpu")
    ref_params = jax.tree.map(jnp.asarray, tree)
    flat = FlatParams.stack({k: torch.from_numpy(v.copy()) for k, v in tree.items()})
    rng = np.random.default_rng(seed + 100)
    for step in range(steps):
        clock = rng.uniform(0, 10, n).astype(np.float32)
        loss = rng.uniform(0, 3, n).astype(np.float32)
        ref_params, ref_info = ref_t.exchange(
            ref_params, RefMeta(jnp.asarray(clock), jnp.asarray(loss)), step
        )
        info = port_t.exchange_params(
            flat, PeerMeta(torch.from_numpy(clock), torch.from_numpy(loss)), step
        )
        yield step, ref_params, ref_info, flat.views(), info


@pytest.mark.parametrize("draws", list(DRAWS))
@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_exchange_bit_equal_to_reference(schedule, wire, draws):
    n = 7  # odd: a pairwise round has a peer that sits out
    kw = dict(**SCHEDULES[schedule], **DRAWS[draws], wire_dtype=wire,
              interpolation="loss", factor=0.9, seed=5)
    participated = []
    for step, ref_p, ref_info, got, info in _run(n, kw, _tree(n, 1)):
        np.testing.assert_array_equal(info.partner.numpy(), np.asarray(ref_info.partner))
        np.testing.assert_array_equal(info.participated.numpy(), np.asarray(ref_info.participated))
        assert _bits_equal(info.alpha.numpy(), ref_info.alpha)
        for name in SHAPES:
            assert _bits_equal(got[name].numpy(), ref_p[name]), (step, name)
        participated.append(info.participated.numpy())
    participated = np.array(participated)
    assert participated.any()
    alpha_seen = np.asarray(ref_info.alpha)
    assert np.any((alpha_seen != 0) & (alpha_seen != 0.5))
    if draws == "partial":  # some paired peers sat a round out by the draws
        assert (~participated).sum() > (0 if schedule == "pull" else 4)


def test_lora_filtered_int8_exchange_keys_leaves_in_flatten_order():
    """Only the selected (LoRA) leaves ship; each is keyed by its place
    among them in flatten order, though the flat buffer puts them first and
    the frozen kernels between them in leaf order."""
    shapes = {
        "layer_0.attn.kernel": (6, 40), "layer_0.attn.lora_a": (6, 2),
        "layer_0.attn.lora_b": (2, 40), "layer_0.mlp.kernel": (40, 9),
        "layer_1.attn.kernel": (6, 40), "layer_1.attn.lora_a": (6, 2),
        "layer_1.attn.lora_b": (2, 300), "norm.scale": (40,),
    }
    n = 4
    rng = np.random.default_rng(2)
    named = {k: rng.standard_normal((n, *s)).astype(np.float32) for k, s in shapes.items()}
    tree = {"params": {}}
    for name, v in named.items():
        node = tree["params"]
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    port_filter = lambda name: ".lora_" in name
    ref_filter = lambda path: "/lora_" in path
    kw = dict(schedule="random", pool_size=4, wire_dtype="int8", interpolation="loss",
              factor=0.9, fetch_probability=0.5, seed=2)
    ref_t = ref_stacked.StackedTransport(ref_config(n, **kw))
    port_t = stacked.StackedTransport(make_local_config(n, **kw), device="cpu")
    flat = FlatParams.stack({k: torch.from_numpy(v.copy()) for k, v in named.items()},
                            first=port_filter)
    assert flat.column_ranges(port_filter) == [(0, flat.column_ranges(port_filter)[0][1])]
    ref_params = jax.tree.map(jnp.asarray, tree)

    @jax.jit
    def ref_exchange(params, meta, step):
        selected, _ = ref_partition(params, ref_filter)
        (merged, _), info = ref_stacked.stacked_gossip_exchange(
            (selected, ()), meta, step, schedule=ref_t.schedule, interp=ref_t.interp
        )
        return merged, info

    for step in range(3):
        clock = rng.uniform(0, 10, n).astype(np.float32)
        loss = rng.uniform(0, 3, n).astype(np.float32)
        before = {k: v.clone() for k, v in flat.views().items()}
        merged, _ = ref_exchange(ref_params, RefMeta(jnp.asarray(clock), jnp.asarray(loss)),
                                 jnp.int32(step))
        port_t.exchange_params(
            flat, PeerMeta(torch.from_numpy(clock), torch.from_numpy(loss)), step, port_filter
        )
        got = flat.views()
        for name in shapes:
            *parents, leaf = name.split(".")
            node = merged["params"]
            for p in parents:
                node = node[p]
            if port_filter(name):
                assert _bits_equal(got[name].numpy(), node[leaf]), (step, name)
            else:
                assert node[leaf] is None and torch.equal(got[name], before[name])
        ref_params = jax.tree.map(
            lambda old, new: old if new is None else new, ref_params, merged,
            is_leaf=lambda v: v is None,
        )


def test_int8_wire_merges_differ_from_f32():
    """The int8 wire changes what arrives: the same round on the f32 wire
    gives other values (so the int8 cases above test the quantizer)."""
    n = 4
    outs = {}
    for wire in ("f32", "int8"):
        kw = dict(schedule="ring", wire_dtype=wire, interpolation="constant", factor=0.3)
        *_, (_, _, _, got, _) = _run(n, kw, _tree(n, 3), steps=1)
        outs[wire] = got["d_scale"].numpy()
    assert not np.array_equal(outs["f32"], outs["int8"])
    np.testing.assert_allclose(outs["f32"], outs["int8"], atol=0.05)


def test_smallnet_int8_exchange_in_own_layout_bit_equal_to_reference():
    """SmallNet in the port's layout (its conv kernel OIHW, Dense kernels
    ``[out, in]``): with the buffer told each kernel's axes to the
    reference's layout (``convert.reference_axes``), the int8 wire's chunks
    hold the reference's elements and two rounds are bit-equal to the
    reference's exchange of the Flax tree; without them they are not."""
    from dpwa_tpu.models.mnist import SmallNet as RefSmallNet
    from dpwa_tpu.train import init_params_per_peer as ref_init_per_peer
    from dpwa_tpu_torch import convert

    n = 4
    variables = ref_init_per_peer(
        lambda k: RefSmallNet().init(k, jnp.zeros((1, 8, 8, 1))), jax.random.key(3), n)
    ref_params = variables["params"]
    own = {k: torch.from_numpy(v) for k, v in convert.flax_to_torch(ref_params, stacked=True).items()}
    axes = convert.reference_axes({k: v.shape[1:] for k, v in own.items()})
    kw = dict(schedule="ring", wire_dtype="int8", interpolation="loss", factor=0.9, seed=3)
    ref_t = ref_stacked.StackedTransport(ref_config(n, **kw))
    ports = {
        given is not None: (stacked.StackedTransport(make_local_config(n, **kw), device="cpu"),
                            FlatParams.stack(Leaves({k: v.clone() for k, v in own.items()}, given)))
        for given in (axes, None)
    }
    rng = np.random.default_rng(3)
    for step in range(2):
        clock = rng.uniform(0, 10, n).astype(np.float32)
        loss = rng.uniform(0, 3, n).astype(np.float32)
        ref_params, _ = ref_t.exchange(ref_params, RefMeta(jnp.asarray(clock), jnp.asarray(loss)), step)
        want = convert.flax_to_torch(jax.tree.map(np.asarray, ref_params), stacked=True)
        for with_axes, (t, flat) in ports.items():
            t.exchange_params(flat, PeerMeta(torch.from_numpy(clock), torch.from_numpy(loss)), step)
            equal = all(_bits_equal(v.numpy(), want[k]) for k, v in flat.views().items())
            assert equal == with_axes, (step, with_axes)
            flat.flat.copy_(FlatParams.stack({k: torch.from_numpy(v) for k, v in want.items()}).flat)


def test_model_init_carries_the_reference_layout_to_the_wire(tmp_path):
    """The port's ResNet and ConvNet ``init`` return their kernels' axes to
    the reference's layouts (``convert.reference_axes``); the per-peer init,
    the stacked state (with BatchNorm's statistics beside the parameters or
    without) and a checkpoint keep them, so no caller passes them on."""
    from dpwa_tpu_torch import checkpoint, convert
    from dpwa_tpu_torch.models import mnist, resnet
    from dpwa_tpu_torch.optim import adam
    from dpwa_tpu_torch.train import init_params_per_peer
    from dpwa_tpu_torch.utils import prng

    t = stacked.StackedTransport(make_local_config(2, wire_dtype="int8"), device="cpu")
    cases = {
        "smallnet": (mnist.build_model((8, 8, 1)), None, 3),
        "resnet8": (resnet.CifarResNet(depth=8, norm_type="batch"), "stats", 10),
    }
    for which, (model, with_stats, n_kernels) in cases.items():
        flat = init_params_per_peer(lambda k: resnet.init(model, k), prng.key(0), 2, "cpu")
        want = convert.reference_axes({k: v.shape[1:] for k, v in flat.views().items()})
        assert len(want) == n_kernels and flat.axes == want, which
        # torch.func maps the init's tree as a dict and keeps its layout.
        grads = torch.func.grad(lambda p: sum(v.sum() for v in p.values()))(
            resnet.init(model, prng.key(1)))
        assert isinstance(grads, Leaves) and grads.axes == want, which
        stats = None
        if with_stats:
            stats = {k: v.expand(2, *v.shape).clone() for k, v in resnet.batch_stats(model).items()}
        state = stacked.init_stacked_state(flat, adam(1e-3), t, stats)
        assert state.params.axes == want and state.params.leaves().axes == want, which
        leaves = state.params.wire_leaves()
        assert sum(len(leaf) == 4 for leaf in leaves) == n_kernels, which
        ckpt = str(tmp_path / which)
        checkpoint.save_checkpoint(ckpt, state)
        assert checkpoint.restore_checkpoint(ckpt).params.axes == want, which
