"""The port's config loading and interpolation against the reference.

The same YAML files load to equal fields in ``dpwa_tpu.config`` and
``dpwa_tpu_torch.config``; α from ``dpwa_tpu_torch.interpolation`` equals
``dpwa_tpu.interpolation``'s bit for bit on a grid of (clock, loss) that
includes NaN, inf and losses beyond the rescue bound.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpwa_tpu import config as ref_config
from dpwa_tpu import interpolation as ref_interp
from dpwa_tpu_torch import config, interpolation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ["examples/cifar10/nodes.yaml", "examples/mnist/nodes.yaml"]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("path", YAMLS)
def test_example_yaml_loads_to_equal_core_fields(path):
    ref = ref_config.load_config(os.path.join(REPO, path))
    port = config.load_config(os.path.join(REPO, path))
    assert port.n_peers == ref.n_peers
    assert [(n.name, n.host, n.port) for n in port.nodes] == [
        (n.name, n.host, n.port) for n in ref.nodes
    ]
    for block in ("protocol", "interpolation", "recovery"):
        mine = _fields(getattr(port, block))
        theirs = _fields(getattr(ref, block))
        assert mine == {k: theirs[k] for k in mine}, block
    assert port.recovery.rescue_bound() == ref.recovery.rescue_bound()


@pytest.mark.parametrize(
    "block",
    ["shard", "health", "chaos", "membership", "trust", "flowctl", "obs",
     "topology", "run", "tune"],
)
def test_unported_block_raises_naming_it(block):
    raw = {"nodes": ["a", "b"], block: {}}
    ref_config.config_from_dict(raw)  # the reference accepts every block
    with pytest.raises(NotImplementedError, match=repr(block)):
        config.config_from_dict(raw)


def test_async_rounds_and_unknown_blocks_raise():
    with pytest.raises(NotImplementedError, match="async_rounds"):
        config.config_from_dict({"nodes": ["a"], "protocol": {"async_rounds": {}}})
    with pytest.raises(NotImplementedError, match="bogus"):
        config.config_from_dict({"nodes": ["a"], "bogus": {}})
    with pytest.raises(ValueError, match="nodes"):
        config.config_from_dict({"protocol": {}})


@pytest.mark.parametrize(
    "kw",
    [
        dict(fetch_probability=1.5),
        dict(schedule="star"),
        dict(mode="push"),
        dict(wire_dtype="fp8"),
        dict(pool_size=0),
    ],
)
def test_protocol_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        ref_config.ProtocolConfig(**kw)
    with pytest.raises(ValueError):
        config.ProtocolConfig(**kw)


def test_make_local_config_matches_reference():
    kw = dict(schedule="hierarchical", group_size=2, inter_period=3, seed=7,
              mode="pull", wire_dtype="bf16", interpolation="clock", factor=0.8)
    ref = ref_config.make_local_config(6, **kw)
    port = config.make_local_config(6, **kw)
    assert port.node_names == ref.node_names
    assert _fields(port.interpolation) == _fields(ref.interpolation)
    theirs = _fields(ref.protocol)
    assert _fields(port.protocol) == {k: theirs[k] for k in _fields(port.protocol)}
    assert port.node_index("node3") == ref.node_index("node3") == 3


def _meta_grid():
    values = np.array(
        [0.0, 1e-9, 0.3, 1.0, 7.5, -2.0, 1e9, 1.6e10, 3e10, -3e10,
         np.nan, np.inf, -np.inf],
        np.float32,
    )
    lc, ll, rc, rl = np.meshgrid(values, values, values[:6], values, indexing="ij")
    return [a.reshape(-1).astype(np.float32) for a in (lc, ll, rc, rl)]


@pytest.mark.parametrize("rescue", [False, True])
@pytest.mark.parametrize(
    "kind", [("constant", 0.5), ("constant", 0.3), ("clock", 1.0), ("clock", 0.7),
             ("loss", 1.0), ("loss", 0.9)]
)
def test_alpha_bit_equal_on_metadata_grid(kind, rescue):
    cfg_kw = dict(type=kind[0], factor=kind[1])
    bound = config.RecoveryConfig().rescue_bound() if rescue else None
    ref = ref_interp.make_interpolation(ref_config.InterpolationConfig(**cfg_kw), bound)
    port = interpolation.make_interpolation(config.InterpolationConfig(**cfg_kw), bound)
    lc, ll, rc, rl = _meta_grid()
    want = np.asarray(
        jax.vmap(ref)(
            ref_interp.PeerMeta(jnp.asarray(lc), jnp.asarray(ll)),
            ref_interp.PeerMeta(jnp.asarray(rc), jnp.asarray(rl)),
        )
    )
    got = port(
        interpolation.PeerMeta(torch.from_numpy(lc), torch.from_numpy(ll)),
        interpolation.PeerMeta(torch.from_numpy(rc), torch.from_numpy(rl)),
    )
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want).all() and (want >= 0).all() and (want <= 1).all()
