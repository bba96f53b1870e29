"""The port's stacked gossip exchange and train step against the reference.

Inputs are made with numpy from a seed and handed to both
``dpwa_tpu.parallel.stacked`` and ``dpwa_tpu_torch.parallel.stacked``.  On
the CPU the port runs its kernels' plain versions; the exchange must match
the reference bit for bit, the train step within the tolerances of
``tests/test_stacked.py`` (losses rtol 1e-5, params rtol 1e-4 / atol 1e-6).
"""

import os
import subprocess
import sys

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
from dpwa_tpu.train import init_params_per_peer as ref_init_per_peer
from dpwa_tpu_torch import convert
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.interpolation import PeerMeta
from dpwa_tpu_torch.models import resnet
from dpwa_tpu_torch.ops import merge
from dpwa_tpu_torch.optim import sgd
from dpwa_tpu_torch.parallel import stacked
from dpwa_tpu_torch.train import softmax_cross_entropy_with_integer_labels
from dpwa_tpu_torch.utils.launch import build_transport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both_configs(n, **kw):
    return ref_config(n, **kw), make_local_config(n, **kw)


@pytest.mark.parametrize("interp", [("constant", 0.3), ("loss", 0.9)])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["pairwise", "pull"])
@pytest.mark.parametrize("schedule", ["ring", "exponential", "hierarchical"])
def test_exchange_bit_equal_to_reference(schedule, mode, wire, interp):
    n, d = 8, 3000
    kw = dict(schedule=schedule, mode=mode, wire_dtype=wire,
              interpolation=interp[0], factor=interp[1])
    if schedule == "hierarchical":
        kw["group_size"] = 4
    ref_cfg, cfg = _both_configs(n, **kw)
    ref_t = ref_stacked.StackedTransport(ref_cfg)
    port_t = stacked.StackedTransport(cfg, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ref_x, port_x = {"w": jnp.asarray(x)}, torch.from_numpy(x.copy())
    for step in range(4):
        clock = rng.uniform(0, 10, n).astype(np.float32)
        loss = rng.uniform(0, 3, n).astype(np.float32)
        ref_x, ref_info = ref_t.exchange(
            ref_x, RefMeta(jnp.asarray(clock), jnp.asarray(loss)), step
        )
        port_x, info = port_t.exchange(
            port_x, PeerMeta(torch.from_numpy(clock), torch.from_numpy(loss)), step
        )
        np.testing.assert_array_equal(port_x.numpy(), np.asarray(ref_x["w"]))
        np.testing.assert_array_equal(info.alpha.numpy(), np.asarray(ref_info.alpha))
        np.testing.assert_array_equal(info.partner.numpy(), np.asarray(ref_info.partner))
        np.testing.assert_array_equal(
            info.participated.numpy(), np.asarray(ref_info.participated)
        )


def test_exchange_columns_leave_the_rest_bit_identical():
    cfg = make_local_config(4, schedule="ring", factor=0.3)
    t = stacked.StackedTransport(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 100)).astype(np.float32))
    before = x.clone()
    meta = PeerMeta(torch.ones(4), torch.ones(4))
    t.exchange(x, meta, 0, columns=[(10, 20), (50, 51)])
    changed = (x != before).any(dim=0)
    assert changed[10:20].all() and changed[50]
    assert not changed[:10].any() and not changed[20:50].any() and not changed[51:].any()
    with pytest.raises(ValueError, match="pull round"):
        stacked.stacked_gossip_exchange(
            x, meta, 0, schedule=t.schedule, interp=t.interp, out=torch.empty_like(x)
        )


def test_pull_exchange_into_out_leaves_x_and_matches_copy_back():
    cfg = make_local_config(4, schedule="ring", mode="pull", factor=0.3)
    t = stacked.StackedTransport(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 100)).astype(np.float32))
    before = x.clone()
    meta = PeerMeta(torch.ones(4), torch.ones(4))
    out = torch.empty_like(x)
    merged, _ = stacked.stacked_gossip_exchange(
        x, meta, 1, schedule=t.schedule, interp=t.interp, out=out
    )
    assert merged is out and torch.equal(x, before)
    copied, _ = t.exchange(x, meta, 1)
    assert copied is x and torch.equal(x, out)


def _resnet8_case(n=4, b=4, hw=16, steps=3, seed=0):
    model = RefResNet(depth=8)
    ref_params = ref_init_per_peer(
        lambda k: model.init(k, jnp.zeros((1, hw, hw, 3))), jax.random.key(seed), n
    )
    rng = np.random.default_rng(seed)
    batches = [
        (rng.random((n, b, hw, hw, 3), np.float32),
         rng.integers(0, 10, (n, b)).astype(np.int32))
        for _ in range(steps)
    ]
    return model, ref_params, batches


@pytest.mark.parametrize(
    "variant", ["plain", "overlap", "exchange_filter", "pull", "pull_overlap"]
)
def test_train_step_matches_reference(variant):
    n = 4
    ref_model, ref_params, batches = _resnet8_case(n)
    overlap = variant.endswith("overlap")
    mode = "pull" if variant.startswith("pull") else "pairwise"
    ref_filter = port_filter = None
    if variant == "exchange_filter":
        ref_filter = lambda p: p.startswith("params/BasicBlock_0/") or "/Dense_0/" in p
        port_filter = lambda name: name.startswith("BasicBlock_0.") or "Dense_0." in name
    ref_cfg, cfg = _both_configs(
        n, schedule="ring", mode=mode, interpolation="loss", factor=0.9
    )

    ref_t = ref_stacked.StackedTransport(ref_cfg)
    ref_opt = optax.sgd(0.1, momentum=0.9)

    def ref_loss(params, batch):
        x, y = batch
        logits = ref_model.apply(params, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    ref_step = ref_stacked.make_stacked_train_step(
        ref_loss, ref_opt, ref_t, exchange_filter=ref_filter, overlap=overlap
    )
    ref_state = ref_stacked.init_stacked_state(ref_params, ref_opt, ref_t)

    model = resnet.CifarResNet(depth=8)
    port_t = stacked.StackedTransport(cfg, device="cpu")
    opt = sgd(0.1, momentum=0.9)

    def loss_fn(params, batch):
        x, y = batch
        logits = torch.func.functional_call(model, params, (x,))
        return softmax_cross_entropy_with_integer_labels(logits, y).mean()

    step = stacked.make_stacked_train_step(
        loss_fn, opt, port_t, exchange_filter=port_filter, overlap=overlap
    )
    named = convert.flax_to_torch(jax.tree.map(np.asarray, ref_params), stacked=True)
    state = stacked.init_stacked_state(
        {k: torch.from_numpy(v) for k, v in named.items()}, opt, port_t
    )
    for x, y in batches:
        ref_state, ref_losses, _ = ref_step(ref_state, (jnp.asarray(x), jnp.asarray(y)))
        state, losses, info = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-5)
        assert bool(info.participated.any())
    assert state.step == len(batches)
    got = convert.torch_to_flax(
        {k: v.numpy() for k, v in state.params.views().items()}, stacked=True
    )
    want = jax.tree.map(np.asarray, ref_state.params)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6), got, want
    )
    # CPU tensors take the plain versions
    assert merge.pair_merge_.launches == 0 and merge.gather_merge.launches == 0


def test_init_state_and_step_guards():
    cfg = make_local_config(4)
    t = stacked.StackedTransport(cfg, device="cpu")
    opt = sgd(0.1)
    with pytest.raises(ValueError, match="leading peer axis"):
        stacked.init_stacked_state({"w": torch.zeros(3, 2)}, opt, t)
    with pytest.raises(NotImplementedError):
        stacked.init_stacked_state({"w": torch.zeros(4, 2)}, opt, t, {"bn": torch.zeros(4)})
    with pytest.raises(NotImplementedError):
        stacked.make_stacked_train_step(lambda p, b: p["w"].sum(), opt, t, with_state=True)
    src = {"w": torch.ones(4, 2)}
    state = stacked.init_stacked_state(src, opt, t)
    state.params.views()["w"].add_(1.0)
    assert torch.equal(src["w"], torch.ones(4, 2))  # the state owns a copy


def test_build_transport_default_device_is_the_card():
    cfg = make_local_config(2)
    if torch.cuda.is_available():
        assert build_transport(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_transport(cfg)
    assert build_transport(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(NotImplementedError):
        build_transport(cfg, "ici", device="cpu")


_NO_JAX_PROBE = """
import sys, torch
from dpwa_tpu_torch.config import load_config
from dpwa_tpu_torch.models import resnet
from dpwa_tpu_torch.optim import sgd
from dpwa_tpu_torch.train import init_params_per_peer, softmax_cross_entropy_with_integer_labels
from dpwa_tpu_torch.utils.launch import build_transport
import dpwa_tpu_torch.examples.cifar10, dpwa_tpu_torch.convert, dpwa_tpu_torch.data

b = build_transport(load_config("examples/cifar10/nodes.yaml"), device="cpu")
model = resnet.CifarResNet(depth=8)
params = init_params_per_peer(lambda g: resnet.init(model, g), torch.Generator().manual_seed(0), 8, "cpu")
opt = sgd(0.1, momentum=0.9)
state = b.init_state(params, opt, b.transport)
def loss_fn(p, batch):
    logits = torch.func.functional_call(model, p, (batch[0],))
    return softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean()
step = b.make_step(loss_fn, opt, b.transport)
state, losses, _ = step(state, (torch.rand(8, 2, 8, 8, 3), torch.zeros(8, 2, dtype=torch.int64)))
assert torch.isfinite(losses).all() and state.step == 1
bad = sorted(m for m in sys.modules if m in ("jax", "flax", "optax", "dpwa_tpu")
             or m.startswith(("jax.", "flax.", "optax.", "dpwa_tpu.")))
print("FORBIDDEN", bad)
"""


def test_port_runs_a_step_without_jax_or_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout
