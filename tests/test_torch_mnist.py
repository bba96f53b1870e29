"""The port's MNIST slice against the reference, on the CPU.

- The digits fixture (``data/digits_fixture/digits.npz``) equals
  ``sklearn.datasets.load_digits()`` value for value, and the port's
  loaders (``gaussian_blobs``, ``load_digits_dataset``,
  ``load_mnist_or_digits``) return the reference's arrays bit for bit.
- ``SmallNet`` (8×8) and ``ConvNet`` (28×28): each peer's init from
  ``prng.key(0)`` against the reference's ``init_params_per_peer`` within 2
  float32 ulps (as the earlier slices' models); logits within rtol 1e-4 /
  atol 1e-5 and every parameter's gradient within rtol 1e-4 / atol 1e-6 of
  Flax's, the parameters carried by ``convert``.
- The example: 14 steps of ``dpwa_tpu_torch.examples.mnist`` against the
  reference's ``run_single_process(stacked=True)`` with the same flags,
  called in process: each step's mean loss within rtol 1e-5 (the stacked
  step tests' loss tolerance), each peer's test accuracy within one test
  image; and the port's save at step 10 plus resume equals its straight
  14-step run bit for bit (parameters, Adam's state, clocks, losses, step,
  the stream's position), as ``tests/test_examples.py:38-45`` holds the
  reference.
"""

import argparse
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpwa_tpu import data as ref_data
from dpwa_tpu.models.mnist import ConvNet as RefConvNet, SmallNet as RefSmallNet
from dpwa_tpu.train import init_params_per_peer as ref_init_per_peer
from dpwa_tpu_torch import convert, data
from dpwa_tpu_torch.examples import mnist as mnist_example
from dpwa_tpu_torch.models import mnist
from dpwa_tpu_torch.train import init_params_per_peer, softmax_cross_entropy_with_integer_labels
from dpwa_tpu_torch.utils import prng

REPO = pathlib.Path(__file__).resolve().parents[1]
MODELS = {"small_8x8": (RefSmallNet, mnist.SmallNet, 8), "conv_28x28": (RefConvNet, mnist.ConvNet, 28)}


def test_digits_fixture_equals_load_digits():
    from sklearn.datasets import load_digits

    digits = load_digits()
    with np.load(data.DIGITS_NPZ) as d:
        images, target = d["images"], d["target"]
    assert images.dtype == np.uint8 and images.shape == (1797, 8, 8)
    np.testing.assert_array_equal(images.astype(np.float64), digits.images)
    np.testing.assert_array_equal(target, digits.target)


@pytest.mark.parametrize("seed", [0, 3])
def test_loaders_bit_equal_to_reference(seed):
    for got, want in zip(data.load_digits_dataset(0.25, seed), ref_data.load_digits_dataset(0.25, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(data.gaussian_blobs(seed=seed, n_per_class=30),
                         ref_data.gaussian_blobs(seed=seed, n_per_class=30)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_load_mnist_or_digits_bit_equal_to_reference(tmp_path, monkeypatch):
    assert data.find_mnist_dir((str(tmp_path),)) is None
    monkeypatch.setattr(ref_data, "find_mnist_dir", lambda: None)
    for got, want in zip(data.load_mnist_or_digits((str(tmp_path),)), ref_data.load_mnist_or_digits()):
        np.testing.assert_array_equal(got, want)
    # An idx directory is found, but only an npz is read (else the digits).
    (tmp_path / "train-images-idx3-ubyte").write_bytes(b"")
    assert data.find_mnist_dir(("/nonexistent", str(tmp_path))) == str(tmp_path)
    assert data.load_mnist_or_digits((str(tmp_path),))[-1] == "digits"
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "mnist.npz",
             x_train=rng.integers(0, 256, (12, 28, 28), dtype=np.uint8),
             y_train=rng.integers(0, 10, 12), x_test=rng.integers(0, 256, (5, 28, 28), dtype=np.uint8),
             y_test=rng.integers(0, 10, 5))
    monkeypatch.setattr(ref_data, "find_mnist_dir", lambda: str(tmp_path))
    got, want = data.load_mnist_or_digits((str(tmp_path),)), ref_data.load_mnist_or_digits()
    assert got[-1] == want[-1] == "mnist"
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _ulp_distance(a, b):
    ai, bi = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    return np.abs(np.where(ai < 0, -(ai & 0x7FFFFFFF), ai) - np.where(bi < 0, -(bi & 0x7FFFFFFF), bi))


@pytest.mark.parametrize("which", list(MODELS))
def test_init_matches_reference_per_peer(which):
    ref_cls, cls, hw = MODELS[which]
    ref = ref_cls()
    want = ref_init_per_peer(lambda k: ref.init(k, jnp.zeros((1, hw, hw, 1))), jax.random.key(0), 2)
    want = convert.flax_to_torch(jax.tree.map(np.asarray, want), stacked=True)
    model = cls()
    flat = init_params_per_peer(lambda k: mnist.init(model, k), prng.key(0), 2, "cpu")
    assert flat.names == tuple(sorted(want, key=lambda n: n.split(".")))
    for name, view in flat.views().items():
        assert view.shape == want[name].shape, name
        assert _ulp_distance(view.numpy(), want[name]).max() <= 2, name
    # The module's own parameters: the draw from prng.key(0) itself.
    assert all(torch.equal(p, mnist.init(model, prng.key(0))[n]) for n, p in model.named_parameters())


@pytest.mark.parametrize("which", list(MODELS))
def test_logits_and_gradients_match_flax(which):
    ref_cls, cls, hw = MODELS[which]
    ref = ref_cls()
    variables = jax.tree.map(np.asarray, ref.init(jax.random.key(1), jnp.zeros((1, hw, hw, 1))))
    rng = np.random.default_rng(hw)
    x = rng.random((3, hw, hw, 1), np.float32)
    y = rng.integers(0, 10, 3).astype(np.int32)

    def ref_loss(params):
        logits = ref.apply({"params": params}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean(), logits

    (_, want), want_grads = jax.value_and_grad(ref_loss, has_aux=True)(variables["params"])
    model = cls()
    params = {k: torch.from_numpy(v) for k, v in convert.flax_to_torch(variables).items()}
    assert set(params) == {n for n, _ in model.named_parameters()}

    def loss(p):
        logits = torch.func.functional_call(model, p, (torch.from_numpy(x),))
        return softmax_cross_entropy_with_integer_labels(logits, torch.from_numpy(y)).mean(), logits

    grads, logits = torch.func.grad(loss, has_aux=True)(params)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    want_g = convert.flax_to_torch({"params": jax.tree.map(np.asarray, want_grads)})
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[name], rtol=1e-4, atol=1e-6, err_msg=name)
    # Dense_0's inputs are in NHWC order: an NCHW flatten gives other logits.
    feats = torch.relu(model.Conv_0(torch.from_numpy(x).permute(0, 3, 1, 2)))
    if hasattr(model, "Conv_1"):
        feats = torch.nn.functional.max_pool2d(torch.relu(model.Conv_1(feats)), 2, 2)
    nchw = torch.func.functional_call(model.Dense_0, {"kernel": params["Dense_0.kernel"],
                                                      "bias": params["Dense_0.bias"]},
                                      (feats.reshape(3, -1),))
    nhwc = torch.func.functional_call(model.Dense_0, {"kernel": params["Dense_0.kernel"],
                                                      "bias": params["Dense_0.bias"]},
                                      (mnist._flatten_nhwc(feats),))
    assert (nchw - nhwc).abs().max() > 1e-3


def _reference_example(argv, capsys):
    """The reference's ``examples/mnist/main.py --transport stacked``, in
    process (JAX compiles once): each step's mean loss and each peer's test
    accuracy, read from what it prints."""
    spec = importlib.util.spec_from_file_location("ref_mnist_main", REPO / "examples/mnist/main.py")
    ref_main = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_main)
    args = argparse.Namespace(config=str(REPO / "examples/mnist/nodes.yaml"), devices="cpu",
                              checkpoint=None, save_every=50, resume=False, **argv)
    capsys.readouterr()
    ref_main.run_single_process(args, stacked=True)
    out = capsys.readouterr().out.splitlines()
    records = [json.loads(line) for line in out if line.startswith("{")]
    accs = next(line for line in out if "per-peer test accuracy" in line)
    return [r["loss_mean"] for r in records], json.loads(accs.split(":", 1)[1])


def test_example_matches_reference_stacked_run(capsys):
    flags = dict(steps=14, batch_size=32, lr=2e-3, log_every=1)
    ref_losses, ref_accs = _reference_example(flags, capsys)
    got = mnist_example.main(["--device", "cpu", "--steps", "14", "--log-every", "1"])
    assert got["dataset"] == "digits" and got["final_step"] == 14 and got["n_peers"] == 2
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-5)
    n_test = 359  # int(1797 * 0.2)
    np.testing.assert_allclose(got["accuracy"], ref_accs, atol=1.0 / n_test + 1e-4)


def _assert_runs_equal(a, b):
    sa, sb = a["state"], b["state"]
    assert sa.step == sb.step == 14
    assert torch.equal(sa.params.flat, sb.params.flat)
    assert torch.equal(sa.opt_state.mu, sb.opt_state.mu) and torch.equal(sa.opt_state.nu, sb.opt_state.nu)
    assert sa.opt_state.count == sb.opt_state.count == 14
    assert torch.equal(sa.clock, sb.clock) and torch.equal(sa.loss, sb.loss)
    assert a["stream"].state_dict() == b["stream"].state_dict()


def test_example_save_and_resume_equals_straight_run(tmp_path):
    """Save at step 10 of 14, resume: the state, the schedule position and
    the data stream all land where the uninterrupted run does."""
    ck = str(tmp_path / "ck")
    base = ["--device", "cpu", "--steps", "14", "--log-every", "100", "--checkpoint", ck]
    full = mnist_example.main(base + ["--save-every", "10"])
    resumed = mnist_example.main(base + ["--resume"])
    assert resumed["start_step"] == 10 and len(resumed["losses"]) == 4
    assert resumed["losses"] == full["losses"][10:]
    _assert_runs_equal(full, resumed)
    assert resumed["accuracy"] == full["accuracy"]
    with pytest.raises(SystemExit):
        mnist_example.main(["--device", "cpu", "--resume"])
