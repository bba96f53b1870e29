"""The port's config loading and interpolation against the reference.

The same YAML files load to equal fields in ``dpwa_tpu.config`` and
``dpwa_tpu_torch.config`` (the ``health:`` block too, and its validation);
the ``membership:``, ``trust:``, ``flowctl:`` and ``chaos:`` blocks load
what the reference loads and refuse what it refuses, and a block of a
plane the port does not have raises :class:`NotImplementedError` naming
it; α from ``dpwa_tpu_torch.interpolation`` equals
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
import yaml

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


@pytest.mark.parametrize("block", ["shard", "obs", "topology", "run", "tune"])
def test_unported_block_raises_naming_it(block):
    raw = {"nodes": ["a", "b"], block: {}}
    ref_config.config_from_dict(raw)  # the reference accepts every block
    with pytest.raises(NotImplementedError, match=repr(block)):
        config.config_from_dict(raw)


@pytest.mark.parametrize("block", ["chaos", "flowctl"])
def test_flowctl_and_chaos_blocks_load_like_the_reference(block):
    """An empty block loads the reference's defaults: flowctl on, chaos
    off."""
    raw = {"nodes": ["a", "b"], block: {}}
    assert _fields(getattr(config.config_from_dict(raw), block)) == _fields(
        getattr(ref_config.config_from_dict(raw), block))
    assert getattr(config.config_from_dict(raw), block).enabled == (block == "flowctl")


@pytest.mark.parametrize("block", ["membership", "trust", "flowctl"])
def test_default_on_block_that_only_disables_loads(block):
    """A default-on block saying only ``enabled: false`` switches the plane
    off, as the reference's does; without the block each of the three is
    on, as in the reference."""
    raw = yaml.safe_load(f"nodes: [a, b]\n{block}: {{enabled: false}}\n")
    assert not getattr(ref_config.config_from_dict(raw), block).enabled
    assert not getattr(config.config_from_dict(raw), block).enabled
    assert getattr(config.config_from_dict({"nodes": ["a"]}), block).enabled


@pytest.mark.parametrize("content", [None, {}, {"enabled": True}, {"enabled": False, "x": 1},
                                     {"indirect_probes": 0}])
@pytest.mark.parametrize("block", ["membership", "trust", "flowctl"])
def test_default_on_block_loads_what_the_reference_loads(block, content):
    """membership, trust and flowctl load what the reference loads, with
    its fields, and refuse what it refuses."""
    doc = {"nodes": ["a", "b"], block: content}
    try:
        ref = getattr(ref_config.config_from_dict(doc), block)
    except TypeError:
        with pytest.raises(TypeError):
            config.config_from_dict(doc)
        return
    mine = getattr(config.config_from_dict(doc), block)
    assert _fields(mine) == {k: v for k, v in _fields(ref).items() if k != "view"} | (
        {"view": None} if block == "membership" else {})


@pytest.mark.parametrize("raw", [{}, {"enabled": False}, {"suspicion_threshold": 3.5,
                                 "quarantine_base_rounds": 2, "jitter_rounds": 0,
                                 "probe_timeout_ms": 250}])
def test_health_block_loads_equal_to_reference(raw):
    doc = {"nodes": ["a", "b"], "health": raw}
    ref = ref_config.config_from_dict(doc).health
    port = config.config_from_dict(doc).health
    assert _fields(port) == _fields(ref)
    assert _fields(config.make_local_config(2, health=raw).health) == _fields(ref)


@pytest.mark.parametrize("kw", [dict(suspicion_threshold=0), dict(ewma_alpha=0.0),
                                dict(success_decay=1.0), dict(quarantine_base_rounds=0),
                                dict(quarantine_max_rounds=2, quarantine_base_rounds=4),
                                dict(jitter_rounds=-1), dict(probe_timeout_ms=0),
                                dict(healthz_port=70000)])
def test_health_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        ref_config.HealthConfig(**kw)
    with pytest.raises(ValueError):
        config.HealthConfig(**kw)


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
