"""The port's Llama against the Flax reference.

The same parameters (the Flax model's init, with ``lora_b`` drawn non-zero
so that the LoRA term is exercised) go through ``dpwa_tpu.models.llama``
and ``dpwa_tpu_torch.models.llama`` by way of ``dpwa_tpu_torch.convert``.
Logits agree at rtol 1e-4 / atol 1e-5 in float32.  With ``dtype=bfloat16``
both packages round the same kernels to bfloat16 and then compute in
float32 (the norm's float32 scale promotes the activations), so only the
order of sums differs — but each norm's output is rounded to bfloat16, and
where the two packages' float32 values straddle a rounding boundary one
activation moves by 2⁻⁸ of itself, which attention spreads over the later
tokens.  So bf16 logits are held at rtol 2e-2 / atol 2e-2 elementwise and
a median absolute difference under 2e-3 (logits are of order 1; computing
the products in bf16 instead of promoting them would move them all).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpwa_tpu.models import llama as ref_llama
from dpwa_tpu.utils.pytree import partition as ref_partition
from dpwa_tpu_torch import convert
from dpwa_tpu_torch.models import llama
from dpwa_tpu_torch.ops import flash_attention
from dpwa_tpu_torch.utils import prng
from dpwa_tpu_torch.utils.pytree import FlatParams

# Reaches the flash kernel's shapes: head_dim 128, T 128.
KERNEL_SHAPES = dict(
    vocab_size=512, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
    d_ff=384, max_seq_len=128, lora_rank=4,
)
# The example's tiny default (head_dim 8: the dense branch).
TINY = dict(
    vocab_size=256, d_model=64, n_layers=4, n_heads=8, n_kv_heads=4,
    d_ff=128, max_seq_len=64, lora_rank=8,
)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _params(cfg_kw, seed=0):
    """Flax init params with every ``lora_b`` replaced by N(0, 0.1²)."""
    ref_model = ref_llama.Llama(ref_llama.LlamaConfig(**cfg_kw))
    t = cfg_kw["max_seq_len"]
    variables = ref_model.init(jax.random.key(seed), jnp.zeros((1, t), jnp.int32))
    named = convert.flax_llama_to_torch(jax.tree.map(np.asarray, variables))
    rng = np.random.default_rng(seed)
    for name, value in named.items():
        if name.endswith("lora_b"):
            named[name] = rng.normal(0, 0.1, value.shape).astype(np.float32)
    return named


def _tokens(cfg_kw, batch=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg_kw["vocab_size"], (batch, cfg_kw["max_seq_len"])).astype(np.int32)


def _assert_logits_close(got, want, dtype):
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        assert np.median(np.abs(got - want)) < 2e-3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", ["kernel_shapes", "tiny"])
def test_logits_match_flax(shape, dtype):
    cfg_kw = KERNEL_SHAPES if shape == "kernel_shapes" else TINY
    jdt, tdt = DTYPES[dtype]
    named = _params(cfg_kw)
    tokens = _tokens(cfg_kw)
    ref_model = ref_llama.Llama(ref_llama.LlamaConfig(**cfg_kw, dtype=jdt))
    want = np.asarray(
        ref_model.apply(convert.torch_llama_to_flax(named), jnp.asarray(tokens))
    )
    model = llama.Llama(llama.LlamaConfig(**cfg_kw, dtype=tdt))
    got = llama.apply(
        model, {k: torch.from_numpy(v) for k, v in named.items()},
        torch.from_numpy(tokens),
    )
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _assert_logits_close(got.detach().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_branch_logits_match_flax(dtype, monkeypatch):
    """``attn_impl="flash"`` takes B5's autograd path (its plain version on
    the CPU): the same logits as the reference, one forward call per layer
    over the whole batch, and no kernel launch on CPU tensors."""
    jdt, tdt = DTYPES[dtype]
    named = _params(KERNEL_SHAPES)
    tokens = _tokens(KERNEL_SHAPES)
    want = np.asarray(
        ref_llama.Llama(ref_llama.LlamaConfig(**KERNEL_SHAPES, dtype=jdt)).apply(
            convert.torch_llama_to_flax(named), jnp.asarray(tokens)
        )
    )
    calls = []
    plain = flash_attention.torch_flash_attn_fwd

    def spy(q, k, v, *, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return plain(q, k, v, causal=causal)

    monkeypatch.setattr(flash_attention, "torch_flash_attn_fwd", spy)
    flash_attention.reset_launch_counts()
    model = llama.Llama(llama.LlamaConfig(**KERNEL_SHAPES, dtype=tdt, attn_impl="flash"))
    got = llama.apply(
        model, {k: torch.from_numpy(v) for k, v in named.items()},
        torch.from_numpy(tokens),
    )
    _assert_logits_close(got.detach().numpy(), want, dtype)
    assert calls == [((2, 128, 2, 128), (2, 128, 1, 128), True)] * 2
    assert flash_attention.flash_attn_fwd.launches == 0


def test_param_names_shapes_and_leaf_order_match_flax():
    named = _params(KERNEL_SHAPES)
    model = llama.Llama(llama.LlamaConfig(**KERNEL_SHAPES))
    assert llama.param_shapes(model) == {k: v.shape for k, v in named.items()}
    ref_leaves = jax.tree_util.tree_flatten_with_path(
        convert.torch_llama_to_flax(named)
    )[0]
    ref_names = [
        ".".join(str(p.key) for p in path[1:]) for path, _ in ref_leaves
    ]
    assert ref_names == list(named)
    back = convert.flax_llama_to_torch(convert.torch_llama_to_flax(named))
    assert list(back) == list(named)
    for name in named:
        np.testing.assert_array_equal(back[name], named[name])


def test_lora_filter_selects_the_reference_partition():
    """The exchanged leaves: the port's ``lora_filter`` on its names selects
    exactly the leaves the reference's ``partition`` selects by key path,
    and the grouped flat layout puts them in one column range."""
    named = _params(KERNEL_SHAPES)
    sel, _ = ref_partition(convert.torch_llama_to_flax(named), ref_llama.lora_filter)
    ref_sel = [
        ".".join(str(p.key) for p in path[1:])
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            sel, is_leaf=lambda x: x is None
        )[0]
        if leaf is not None
    ]
    port_sel = [name for name in named if llama.lora_filter(name)]
    assert port_sel == ref_sel and len(port_sel) == 4 * 7  # 7 dense per layer
    shapes = [named[k].shape for k in named]
    plain = FlatParams(list(named), shapes, 1)
    grouped = FlatParams(list(named), shapes, 1, first=llama.lora_filter)
    lora_size = sum(named[k].size for k in port_sel)
    assert len(plain.column_ranges(llama.lora_filter)) == 14  # 2 layers x 7 runs
    assert grouped.column_ranges(llama.lora_filter) == [(0, lora_size)]
    assert list(grouped.views()) == list(named)


def test_init_follows_flax_initialisers():
    cfg = llama.LlamaConfig(**KERNEL_SHAPES)
    model = llama.Llama(cfg)
    params = llama.init(model, prng.key(0))
    assert all(p.dtype == torch.float32 for p in params.values())
    emb = params["embed.embedding"]
    assert abs(emb.std().item() - (1 / 256) ** 0.5) < 0.05 * (1 / 256) ** 0.5
    k = params["layer_0.mlp.w_down.kernel"]  # fan_in = d_ff
    std = (1 / 384) ** 0.5 / 0.87962566103423978
    assert k.abs().max().item() <= 2 * std + 1e-6
    assert abs(k.std().item() - (1 / 384) ** 0.5) < 0.05 * (1 / 384) ** 0.5
    assert torch.equal(params["layer_1.attn.wq.lora_b"], torch.zeros(4, 256))
    assert abs(params["layer_1.attn.wq.lora_a"].std().item() - 0.02) < 0.002
    assert torch.equal(params["final_norm.scale"], torch.ones(256))


def _ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ai, bi = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    return np.abs(np.where(ai < 0, -(ai & 0x7FFFFFFF), ai) - np.where(bi < 0, -(bi & 0x7FFFFFFF), bi))


INIT_CONFIGS = {
    # the example's tiny model (examples/llama_lora/main.py without --full-size)
    "example_tiny": dict(vocab_size=256, d_model=64, n_layers=4, n_heads=8, n_kv_heads=4,
                         d_ff=128, max_seq_len=64, lora_rank=8),
    "mha_no_lora": dict(vocab_size=300, d_model=96, n_layers=1, n_heads=4, d_ff=160,
                        max_seq_len=16, lora_rank=0),
}


@pytest.mark.parametrize("name", list(INIT_CONFIGS))
def test_init_matches_flax_model_init_per_peer(name):
    """The port's per-peer init from ``prng.key(0)`` against the reference's
    ``init_params_per_peer`` (``jax.vmap(model.init)`` over
    ``jax.random.split(key(0), 4)``): every drawn leaf within 2 float32
    ulps and at least 95 % of its values bit-equal, ``lora_b`` and the norm
    scales exact."""
    from dpwa_tpu.train import init_params_per_peer as ref_init_per_peer
    from dpwa_tpu_torch.train import init_params_per_peer

    kw = INIT_CONFIGS[name]
    ref = ref_llama.Llama(ref_llama.LlamaConfig(**kw))
    want = convert.flax_llama_to_torch(jax.tree.map(np.asarray, ref_init_per_peer(
        lambda k: ref.init(k, jnp.zeros((1, 8), jnp.int32)), jax.random.key(0), 4)))
    model = llama.Llama(llama.LlamaConfig(**kw))
    got = init_params_per_peer(lambda k: llama.init(model, k), prng.key(0), 4, "cpu").views()
    assert list(got) == list(want)
    for leaf, value in got.items():
        g, w = value.numpy(), want[leaf]
        assert g.shape == w.shape, leaf
        if leaf.rsplit(".", 1)[-1] in ("kernel", "embedding", "lora_a"):
            d = _ulp_distance(g, w)
            assert d.max() <= 2 and (d == 0).mean() >= 0.95, (leaf, d.max(), (d == 0).mean())
        else:
            np.testing.assert_array_equal(g, w)


def test_sp_axis_is_not_ported():
    """The sequence-parallel path is ported now (tests/test_torch_sp.py):
    ``sp_axis`` builds, and its options are validated as the reference
    validates them."""
    assert llama.LlamaConfig(sp_axis="sp").sp_axis == "sp"
    with pytest.raises(ValueError, match="requires sp_axis"):
        llama.LlamaConfig(sp_layout="zigzag")
    with pytest.raises(ValueError, match="attn_impl"):
        llama.LlamaConfig(attn_impl="xla")
