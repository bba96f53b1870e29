"""The port's int8 wire (``dpwa_tpu_torch.ops.quantize``) and the schedules'
participation and fault draws against the reference, bit for bit.

The reference's quantizer is held as every one of its callers runs it:
compiled (``jax.jit``), where XLA's simplifier turns the division of the
chunk's largest magnitude by 127 into a product with float32(1/127).  An
op-by-op call divides instead and differs in the last bit of some scales;
``test_eager_reference_divides_by_127`` pins that difference, so a change
in either shows.  Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.ops import quantize as ref_q
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu.utils import pytree as ref_pytree
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.ops import quantize
from dpwa_tpu_torch.parallel import schedules
from dpwa_tpu_torch.utils import pytree

KEYS = [(0, 0, 0, 0), (3, 7, 5, 2), (12345, 100000, 31, 160)]  # seed, step, sender, leaf


def _leaf(kind):
    rng = np.random.default_rng(len(kind))
    if kind.startswith("size"):
        return rng.standard_normal(int(kind[4:])).astype(np.float32)
    if kind == "kernel":
        return rng.standard_normal((3, 3, 64, 64)).astype(np.float32)
    v = rng.standard_normal(1000).astype(np.float32)
    if kind == "zero_chunk":
        v[256:512] = 0.0
    elif kind == "huge_value":
        v[300] *= 1e30  # one value 1e30 times the rest of its chunk
    elif kind == "non_finite":
        v[10], v[300], v[600] = np.inf, np.nan, -np.inf
    return v


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    both_nan = np.isnan(a) & np.isnan(b)
    return a.shape == b.shape and bool(np.all((a.view(np.int32) == b.view(np.int32)) | both_nan))


@pytest.mark.parametrize("seed,step,sender,leaf", KEYS)
def test_wire_key_matches_reference(seed, step, sender, leaf):
    want = ref_q.wire_key(seed, jnp.int32(step), jnp.int32(sender), leaf)
    assert quantize.wire_key(seed, step, sender, leaf) == tuple(
        int(w) for w in np.asarray(jax.random.key_data(want))
    )


@pytest.mark.parametrize(
    "kind",
    ["size1", "size255", "size256", "size257", "kernel", "zero_chunk", "huge_value", "non_finite"],
)
def test_quantize_dequantize_bit_equal_to_compiled_reference(kind):
    v = _leaf(kind)
    for seed, step, sender, leaf in KEYS:
        rk = ref_q.wire_key(seed, jnp.int32(step), jnp.int32(sender), leaf)
        want_q, want_s = jax.jit(ref_q.quantize)(jnp.asarray(v), rk)
        q, s = quantize.quantize(torch.from_numpy(v), quantize.wire_key(seed, step, sender, leaf))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        assert _bits_equal(s.numpy(), want_s)
        want = jax.jit(ref_q.dequantize, static_argnums=2)(want_q, want_s, v.shape)
        assert _bits_equal(quantize.dequantize(q, s, v.shape).numpy(), want)
        fq = jax.jit(ref_q.fake_quant_wire, static_argnums=(1, 4))(
            jnp.asarray(v), seed, jnp.int32(step), jnp.int32(sender), leaf
        )
        got = quantize.fake_quant_wire(torch.from_numpy(v), seed, step, sender, leaf)
        assert _bits_equal(got.numpy(), fq)
    if kind == "non_finite":  # every chunk with an inf or a NaN ships NaN
        assert np.isnan(got.numpy()[:768]).all() and np.isfinite(got.numpy()[768:]).all()
    if kind == "zero_chunk":
        assert (got.numpy()[256:512] == 0).all()


def test_eager_reference_divides_by_127():
    """The op-by-op reference divides by 127 and the compiled one
    multiplies by float32(1/127): over these chunks some scales differ in
    the last bit, and the port gives the compiled bits."""
    v = np.random.default_rng(1).standard_normal(3000).astype(np.float32)
    k = ref_q.wire_key(0, jnp.int32(0), jnp.int32(1), 0)
    eager = np.asarray(ref_q.quantize(jnp.asarray(v), k)[1])
    compiled = np.asarray(jax.jit(ref_q.quantize)(jnp.asarray(v), k)[1])
    port = quantize.quantize(torch.from_numpy(v), quantize.wire_key(0, 0, 1, 0))[1].numpy()
    assert (eager != compiled).any()
    assert _bits_equal(port, compiled)
    chunks = np.abs(np.pad(v, (0, 72)).reshape(12, 256)).max(1)
    assert _bits_equal(eager, chunks / np.float32(127))


def test_fake_quant_tree_bit_equal_to_reference():
    rng = np.random.default_rng(3)
    tree = {
        "a": rng.standard_normal((3, 5)).astype(np.float32),
        "b": rng.standard_normal(700).astype(np.float32),
        "c": np.arange(4, dtype=np.int32),
        "d": rng.standard_normal((2, 2, 8, 8)).astype(np.float32),
    }
    want = jax.jit(ref_q.fake_quant_tree, static_argnums=1)(
        jax.tree.map(jnp.asarray, tree), 9, jnp.int32(4), jnp.int32(2)
    )
    got = quantize.fake_quant_tree({k: torch.from_numpy(v) for k, v in tree.items()}, 9, 4, 2)
    assert list(got) == sorted(tree)
    for name in tree:
        assert _bits_equal(got[name].numpy(), want[name]) if name != "c" else torch.equal(
            got[name], torch.from_numpy(tree["c"])
        )


@pytest.mark.parametrize("max_elements", [512, 1 << 24])
def test_fake_quant_rows_bit_equal_to_vmapped_reference(max_elements):
    """The exchange's batched form: every sender's rows of a flat buffer,
    leaf by leaf, in blocks of rows and chunks, against the reference's
    ``vmap`` of ``fake_quant_tree`` over the senders (leaf i's columns hold
    the i-th leaf in flatten order)."""
    n, sizes = 4, [300, 256, 1, 4000]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, sum(sizes) + 7)).astype(np.float32)
    x[2, 310:320] = np.inf
    ends = np.cumsum([0, *sizes])
    leaves = [(int(ends[i]), int(ends[i + 1])) for i in range(len(sizes))]
    tree = {f"l{i}": jnp.asarray(x[:, lo:hi]) for i, (lo, hi) in enumerate(leaves)}
    want = jax.jit(jax.vmap(lambda row, s: ref_q.fake_quant_tree(row, 9, jnp.int32(4), s)))(
        tree, jnp.arange(n)
    )
    w = torch.full((n, x.shape[1]), 7.0)
    quantize.fake_quant_rows(
        torch.from_numpy(x), w, quantize.WirePlan(leaves, "cpu"), 9, 4, max_elements
    )
    for i, (lo, hi) in enumerate(leaves):
        assert _bits_equal(w[:, lo:hi].numpy(), want[f"l{i}"]), i
    assert (w[:, ends[-1]:] == 7.0).all()  # columns outside the leaves untouched


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_tree_wire_bytes_matches_reference(wire):
    rng = np.random.default_rng(0)
    tree = {
        "a": rng.standard_normal((3, 5)).astype(np.float32),
        "b": rng.standard_normal(700).astype(np.float32),
        "c": np.arange(4, dtype=np.int32),
        "e": np.zeros(0, np.float32),
        "k": rng.standard_normal((3, 3, 64, 64)).astype(np.float32),
    }
    want = ref_pytree.tree_wire_bytes(jax.tree.map(jnp.asarray, tree), wire)
    assert pytree.tree_wire_bytes({k: torch.from_numpy(v) for k, v in tree.items()}, wire) == want


@pytest.mark.parametrize("p", [0.0, 0.1, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_participation_and_fault_draws_bit_equal(seed, p):
    for step in (0, 1, 17, 99_999, 2**31 - 1):
        for pair_id in (0, 1, 5, 31):
            assert schedules.participation_draw(seed, step, pair_id, p) == bool(
                ref_schedules.participation_draw(seed, step, pair_id, p)
            )
            assert schedules.fault_draw(seed, step, pair_id, p) == bool(
                ref_schedules.fault_draw(seed, step, pair_id, p)
            )


@pytest.mark.parametrize("mode", ["pairwise", "pull"])
@pytest.mark.parametrize("schedule", ["ring", "random"])
def test_participates_and_drawn_mask_match_reference(schedule, mode):
    kw = dict(schedule=schedule, mode=mode, fetch_probability=0.5, drop_probability=0.25, seed=3)
    ref = ref_schedules.build_schedule(ref_config(7, **kw))
    port = schedules.build_schedule(make_local_config(7, **kw))
    assert port.draws
    for step in range(12):
        want = [ref.participates(step, i) for i in range(7)]
        assert [port.participates(step, i) for i in range(7)] == want
        pairing = port.pairing(step)
        drawn = port.drawn(step, pairing) & (pairing != np.arange(7))
        assert drawn.tolist() == want
