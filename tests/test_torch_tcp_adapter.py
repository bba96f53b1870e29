"""The TCP adapters and the MNIST example's TCP path against the reference,
on the CPU over localhost sockets.

- The frame order: a port tree of SmallNet, ConvNet or ResNet-8 in the
  port's layouts (conv kernels OIHW, Dense kernels ``[out, in]``), gathered
  by ``FlatParams.reference_order`` with ``convert.reference_axes``, is
  ``jax.flatten_util.ravel_pytree`` of the Flax tree bit for bit, and the
  scatter back writes the reference's unravelled tree.
- ``DpwaTcpAdapter`` and ``DpwaTorchAdapter`` (with the alias
  ``DpwaPyTorchAdapter``) in pairs run lock-step for 4 rounds at α = 0.3:
  port pairs and mixed pairs end bit-equal to a reference pair (the
  reference's planes off, so the reference merges unscaled), the pattern of
  ``tests/test_adapters.py``.  ``bootstrap=True`` raises.
- Two nodes of ``dpwa_tpu_torch.examples.mnist --transport tcp`` against
  two of the reference's ``examples/mnist/main.py`` ``run_tcp``, each
  package from its own init, in threads of this process, every fetch held
  between two barriers so both nodes of a package merge the same frames
  (free-running processes fetch whatever the partner last published):
  each step's loss within rtol 1e-5 (the stacked example's tolerance,
  ``tests/test_torch_mnist.py``), the test accuracy within one image.
- ``dpwa_tpu_torch.examples.mnist_torch`` against the reference's
  ``examples/mnist_torch/main.py`` (both torch), two nodes each the same
  way at α 0.3: each step's loss within rtol 1e-5, the accuracy within one
  image, the final parameters bit for bit.
"""

import argparse
import dataclasses
import importlib.util
import json
import socket
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from dpwa_tpu.adapters.tcp_adapter import DpwaTcpAdapter as RefTcpAdapter
from dpwa_tpu.adapters.tcp_adapter import DpwaTorchAdapter as RefTorchAdapter
from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.models.mnist import ConvNet as RefConvNet, SmallNet as RefSmallNet
from dpwa_tpu.models.resnet import CifarResNet as RefResNet
from dpwa_tpu.parallel import tcp as ref_tcp
from dpwa_tpu_torch import convert
from dpwa_tpu_torch.adapters import DpwaPyTorchAdapter, DpwaTcpAdapter, DpwaTorchAdapter
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.examples import mnist as mnist_example
from dpwa_tpu_torch.examples import mnist_torch as mnist_torch_example
from dpwa_tpu_torch.parallel import tcp
from dpwa_tpu_torch.utils.pytree import FlatParams, Leaves, leaf_order

REPO = Path(__file__).resolve().parents[1]
PLANES_OFF = dict(
    health={"enabled": False}, membership={"enabled": False},
    trust={"enabled": False}, flowctl={"enabled": False},
)


@pytest.fixture(autouse=True)
def _socket_timeout():
    prev = socket.getdefaulttimeout()
    socket.setdefaulttimeout(10.0)
    try:
        yield
    finally:
        socket.setdefaulttimeout(prev)


def _ephemeral(cfg):
    return dataclasses.replace(
        cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes)
    )


MODELS = {
    "smallnet": lambda: (RefSmallNet(), (1, 8, 8, 1)),
    "convnet": lambda: (RefConvNet(), (1, 28, 28, 1)),
    "resnet8": lambda: (RefResNet(depth=8), (1, 8, 8, 3)),
}


@pytest.mark.parametrize("which", list(MODELS))
def test_reference_order_is_ravel_pytree(which):
    model, shape = MODELS[which]()
    params = jax.tree.map(np.asarray, model.init(jax.random.key(1), jnp.zeros(shape))["params"])
    want, unravel = ravel_pytree(params)
    own = {k: torch.from_numpy(v) for k, v in convert.flax_to_torch(params).items()}
    names = leaf_order(own)
    flat = FlatParams(names, [tuple(own[k].shape) for k in names], 1,
                      axes=convert.reference_axes(own))
    for k, view in flat.views().items():
        view[0].copy_(own[k])
    order = torch.from_numpy(flat.reference_order())
    assert sorted(order.tolist()) == list(range(flat.size))
    assert np.array_equal(flat.flat[0][order].numpy(), np.asarray(want))
    # The scatter back: a new vector lands as the reference unravels it.
    v = np.random.default_rng(0).standard_normal(want.size).astype(np.float32)
    flat.flat[0].index_copy_(0, order, torch.from_numpy(v))
    back = convert.flax_to_torch(jax.tree.map(np.asarray, unravel(jnp.asarray(v))))
    for k, view in flat.views().items():
        assert np.array_equal(view[0].numpy(), back[k]), k


def _smallnet_init(i):
    return jax.tree.map(np.asarray, RefSmallNet().init(jax.random.key(i), jnp.zeros((1, 8, 8, 1))))


def _tree_adapters(kinds, cfgs):
    out = []
    try:
        for i, kind in enumerate(kinds):
            init = _smallnet_init(i)
            if kind == "ref":
                out.append(RefTcpAdapter(init, f"node{i}", cfgs["ref"]))
            else:
                own = {k: torch.from_numpy(v) for k, v in convert.flax_to_torch(init).items()}
                out.append(DpwaTcpAdapter(Leaves(own, convert.reference_axes(own)), f"node{i}",
                                          cfgs["port"], device="cpu"))
        for a in out:
            for i, other in enumerate(out):
                a.transport.set_peer_port(i, other.transport.port)
    except BaseException:
        for a in out:
            a.close()
        raise
    return out


def _flax_of(adapter):
    """The adapter's replica as the reference's flat vector."""
    if isinstance(adapter, RefTcpAdapter):
        return np.asarray(adapter._vec)
    return adapter.vector().numpy()


def test_tcp_adapters_match_reference_pair():
    kw = dict(schedule="ring", interpolation="constant", factor=0.3)
    cfgs = {"ref": _ephemeral(ref_config(2, base_port=0, **kw, **PLANES_OFF)),
            "port": _ephemeral(make_local_config(2, **kw))}
    finals = {}
    for kinds in (("ref", "ref"), ("port", "port"), ("ref", "port")):
        adapters = _tree_adapters(kinds, cfgs)
        try:
            for r in range(4):
                loss = 1.0 + 0.25 * r
                for a in adapters:  # lock-step: this round's frames first
                    a.transport.publish(_flax_of(a) if isinstance(a, RefTcpAdapter)
                                        else a.vector(), r + 1.0, loss)
                for a in adapters:
                    a.update(loss)
                    assert a.last_alpha == pytest.approx(0.3) and a.last_partner == 1 - a.transport.me
            finals[kinds] = [_flax_of(a) for a in adapters]
        finally:
            for a in adapters:
                a.close()
    for kinds, got in finals.items():
        for v, w in zip(got, finals[("ref", "ref")]):
            assert np.array_equal(v.view(np.int32), w.view(np.int32)), kinds
    assert not np.array_equal(finals[("ref", "ref")][0], _smallnet_init(0))


class _Net(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        torch.manual_seed(seed)
        self.conv = torch.nn.Conv2d(1, 4, 3, padding=1)
        self.fc = torch.nn.Linear(4 * 8 * 8, 10)


def test_torch_adapters_match_reference_pair():
    assert DpwaPyTorchAdapter is DpwaTorchAdapter
    kw = dict(schedule="ring", interpolation="constant", factor=0.3)
    cfgs = {"ref": _ephemeral(ref_config(2, base_port=0, **kw, **PLANES_OFF)),
            "port": _ephemeral(make_local_config(2, **kw))}
    finals = {}
    for kinds in (("ref", "ref"), ("port", "port"), ("port", "ref")):
        models = [_Net(i) for i in range(2)]
        adapters = []
        try:
            for i, kind in enumerate(kinds):
                cls = RefTorchAdapter if kind == "ref" else DpwaTorchAdapter
                adapters.append(cls(models[i], f"node{i}", cfgs[kind]))
            for a in adapters:
                for i, other in enumerate(adapters):
                    a.transport.set_peer_port(i, other.transport.port)
            for r in range(4):
                for m in models:  # a local "step" between rounds
                    with torch.no_grad():
                        for p in m.parameters():
                            p.mul_(0.9).add_(0.01 * (r + 1))
                for a in adapters:
                    a.transport.publish(a._flatten(), a._clock + 1.0, 0.5)
                for a in adapters:
                    a.update(0.5)
                    assert a.last_alpha == pytest.approx(0.3)
            finals[kinds] = [torch.cat([p.detach().reshape(-1) for p in m.parameters()]).numpy()
                             for m in models]
        finally:
            for a in adapters:
                a.close()
    for kinds, got in finals.items():
        for v, w in zip(got, finals[("ref", "ref")]):
            assert np.array_equal(v.view(np.int32), w.view(np.int32)), kinds


def test_bootstrap_is_not_ported(monkeypatch):
    cfg = _ephemeral(make_local_config(2))
    with pytest.raises(NotImplementedError, match="bootstrap"):
        DpwaTcpAdapter({"w": torch.ones(3)}, "node0", cfg, device="cpu", bootstrap=True)
    monkeypatch.setenv("DPWA_BOOTSTRAP", "1")
    with pytest.raises(NotImplementedError, match="bootstrap"):
        DpwaTorchAdapter(torch.nn.Linear(2, 2), "node0", cfg)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _lockstep_fetch(monkeypatch, cls):
    """Hold every fetch between two barriers: both nodes have published
    this round's frame before either fetches, and neither publishes the
    next before both have fetched."""
    barrier = threading.Barrier(2, timeout=60)
    orig = cls.fetch

    def fetch(self, *args, **kwargs):
        barrier.wait()
        try:
            return orig(self, *args, **kwargs)
        finally:
            barrier.wait()

    monkeypatch.setattr(cls, "fetch", fetch)


def _run_pair(target):
    errors, threads = [], []
    for name in ("node0", "node1"):
        def run(name=name):
            try:
                target(name)
            except BaseException as e:  # surfaced below
                errors.append(e)
        threads.append(threading.Thread(target=run))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


def test_mnist_tcp_example_matches_reference_run_tcp(tmp_path, monkeypatch, capsys):
    steps = 6
    ports = _free_ports(2)
    yaml = tmp_path / "nodes.yaml"
    yaml.write_text(
        "nodes:\n"
        + "".join(f"  - {{name: node{i}, host: 127.0.0.1, port: {p}}}\n" for i, p in enumerate(ports))
        + "protocol: {schedule: ring, fetch_probability: 1.0, timeout_ms: 2000, seed: 0}\n"
        + "interpolation: {type: constant, factor: 0.5}\n"
    )
    spec = importlib.util.spec_from_file_location("ref_mnist_main", REPO / "examples/mnist/main.py")
    ref_main = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_main)

    _lockstep_fetch(monkeypatch, ref_tcp.TcpTransport)
    _run_pair(lambda name: ref_main.run_tcp(argparse.Namespace(
        config=str(yaml), name=name, platform="cpu", lr=2e-3, steps=steps,
        batch_size=32, log_every=1)))
    out = capsys.readouterr().out.splitlines()
    ref = {f"node{i}": {"losses": {}, "acc": None} for i in range(2)}
    for line in out:
        if line.startswith("{"):
            rec = json.loads(line)
            ref[rec["node"]]["losses"][rec["step"]] = rec["loss"]
        elif "test accuracy" in line:
            node = line.split("]")[0].lstrip("[")
            ref[node]["acc"] = float(line.rsplit(":", 1)[1])

    _lockstep_fetch(monkeypatch, tcp.TcpTransport)
    got = {}
    _run_pair(lambda name: got.__setitem__(name, mnist_example.main([
        "--transport", "tcp", "--name", name, "--config", str(yaml), "--device", "cpu",
        "--steps", str(steps), "--log-every", "100"])))
    n_test = 359
    for name, res in got.items():
        assert res["dataset"] == "digits" and res["merged_rounds"] == steps
        assert res["outcomes"] == {"success": steps}
        want = [ref[name]["losses"][s] for s in range(steps)]
        np.testing.assert_allclose(res["losses"], want, rtol=1e-5, err_msg=name)
        assert abs(res["accuracy"] - ref[name]["acc"]) <= 1.0 / n_test + 1e-4


def _serialised_model_init(monkeypatch, init_lock):
    """Both scripts seed torch's global generator (``torch.manual_seed(me)``)
    and then build their model from it; two nodes in threads must not
    interleave there.  The seed takes ``init_lock``, and the adapter, built
    right after the model, gives it back."""
    seed = torch.manual_seed

    def manual_seed(s):
        assert init_lock.acquire(timeout=60)
        return seed(s)

    monkeypatch.setattr(torch, "manual_seed", manual_seed)


def _recording_adapter(cls, init_lock, record):
    """``cls`` that records each node's losses and α and its model."""

    class Recording(cls):
        def __init__(self, model, name, config, *args, **kwargs):
            init_lock.release()
            super().__init__(model, name, config, *args, **kwargs)
            self._rec = record.setdefault(name, {"losses": [], "alphas": [], "model": model})

        def update(self, loss):
            self._rec["losses"].append(loss)
            super().update(loss)
            self._rec["alphas"].append(self.last_alpha)

    return Recording


def test_mnist_torch_example_matches_reference_script(tmp_path, monkeypatch, capsys):
    """The reference's PyTorch-adapter script (``examples/mnist_torch/
    main.py``) and its port, two nodes each in threads of this process on
    the CPU, every fetch held between barriers, α 0.3 (the reference's
    planes off, so its α is the factor as it stands): the same losses each
    step within rtol 1e-5, the same test accuracy within one image, and
    final parameters bit for bit."""
    steps = 6
    ports = _free_ports(2)
    nodes = "nodes:\n" + "".join(
        f"  - {{name: node{i}, host: 127.0.0.1, port: {p}}}\n" for i, p in enumerate(ports))
    common = ("protocol: {schedule: ring, fetch_probability: 1.0, timeout_ms: 2000, seed: 0}\n"
              "interpolation: {type: constant, factor: 0.3}\n")
    yaml = tmp_path / "nodes.yaml"
    yaml.write_text(nodes + common)
    ref_yaml = tmp_path / "ref_nodes.yaml"
    ref_yaml.write_text(nodes + common + "".join(f"{k}: {{enabled: false}}\n" for k in PLANES_OFF))
    spec = importlib.util.spec_from_file_location(
        "ref_mnist_torch_main", REPO / "examples/mnist_torch/main.py")
    ref_main = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_main)
    argv = threading.local()
    parse_args = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        lambda self, args=None, ns=None: parse_args(
                            self, argv.args if args is None else args, ns))
    init_lock = threading.Lock()
    _serialised_model_init(monkeypatch, init_lock)
    import dpwa_tpu.adapters.tcp_adapter as ref_adapters
    import dpwa_tpu_torch.adapters.tcp_adapter as port_adapters

    ref = {}
    monkeypatch.setattr(ref_adapters, "DpwaPyTorchAdapter",
                        _recording_adapter(RefTorchAdapter, init_lock, ref))
    _lockstep_fetch(monkeypatch, ref_tcp.TcpTransport)

    def run_ref(name):
        argv.args = ["--name", name, "--config", str(ref_yaml), "--steps", str(steps)]
        ref_main.main()

    _run_pair(run_ref)
    for line in capsys.readouterr().out.splitlines():
        if "test accuracy" in line:
            ref[line.split("]")[0].lstrip("[")]["acc"] = float(line.rsplit(":", 1)[1])

    port = {}
    monkeypatch.setattr(port_adapters, "DpwaPyTorchAdapter",
                        _recording_adapter(DpwaTorchAdapter, init_lock, port))
    _lockstep_fetch(monkeypatch, tcp.TcpTransport)
    got = {}
    _run_pair(lambda name: got.__setitem__(name, mnist_torch_example.main([
        "--name", name, "--config", str(yaml), "--device", "cpu", "--steps", str(steps)])))
    n_test = 359
    for name, res in got.items():
        assert port[name]["alphas"] == ref[name]["alphas"] == [pytest.approx(0.3)] * steps, name
        assert res["losses"] == port[name]["losses"]
        np.testing.assert_allclose(res["losses"], ref[name]["losses"], rtol=1e-5, err_msg=name)
        assert abs(res["accuracy"] - ref[name]["acc"]) <= 1.0 / n_test + 1e-4, name
        for p, q in zip(port[name]["model"].parameters(), ref[name]["model"].parameters()):
            assert torch.equal(p.detach().view(torch.int32), q.detach().view(torch.int32)), name
