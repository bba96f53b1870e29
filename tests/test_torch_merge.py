"""The port's merge ops against the reference.

The plain versions of the two kernels must equal the reference's stacked
exchange bit for bit (``dpwa_tpu.parallel.stacked.stacked_gossip_exchange``,
whose merge is the fused float32 form of ``(1−α)·x + α·y``), and agree with
the Pallas kernels in interpret mode at the reference's own tolerance
(``tests/test_merge_ops.py``: rtol 3e-4, atol 1e-6).  The CUDA kernels
themselves run only on the card and are held bit for bit against these
plain versions there (``tests/test_torch_card.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.interpolation import PeerMeta as RefMeta
from dpwa_tpu.ops import merge as ref_merge
from dpwa_tpu.parallel import schedules as ref_schedules
from dpwa_tpu.parallel.stacked import stacked_gossip_exchange
from dpwa_tpu_torch.ops import merge

N = 8
RING_EVEN = np.array([1, 0, 3, 2, 5, 4, 7, 6])
RING_ODD = np.array([7, 2, 1, 4, 3, 6, 5, 0])
WITH_FIXED = np.array([1, 0, 2, 3, 5, 4, 6, 7])  # rows 2, 3, 6, 7 sit out


def _alpha(kind, seed=0):
    if kind == "0.3":
        return np.full(N, 0.3, np.float32)
    return np.random.default_rng(seed).uniform(0, 1, N).astype(np.float32)


def _reference(x, partner, alpha, mode, wire):
    """The reference's stacked exchange with ``partner`` as its one-row
    pool and α carried in the loss metadata."""
    cfg = ref_config(N, mode=mode, wire_dtype=wire)
    sched = ref_schedules.build_schedule(cfg)
    sched = type(sched)(**{**sched.__dict__, "pool": partner[None].astype(np.int32),
                           "branch_map": None})
    meta = RefMeta(jnp.ones(N, jnp.float32), jnp.asarray(alpha))
    out, info = jax.jit(
        lambda p, m: stacked_gossip_exchange(
            p, m, 0, schedule=sched, interp=lambda local, remote: local.loss
        )
    )({"w": jnp.asarray(x)}, meta)
    return np.array(out["w"]), np.array(info.alpha)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("alpha_kind", ["0.3", "random"])
@pytest.mark.parametrize("d", [2048, 272474])
@pytest.mark.parametrize("pool", ["ring_even", "ring_odd", "with_fixed"])
def test_plain_pair_merge_bit_equal_to_reference_exchange(pool, d, alpha_kind, wire):
    partner = {"ring_even": RING_EVEN, "ring_odd": RING_ODD, "with_fixed": WITH_FIXED}[pool]
    x = np.random.default_rng(d).standard_normal((N, d)).astype(np.float32)
    want, masked_alpha = _reference(x, partner, _alpha(alpha_kind), "pairwise", wire)
    left, right = merge.involution_pairs(partner, pad_to=4)
    got = merge.torch_pair_merge_(
        torch.from_numpy(x.copy()), torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(masked_alpha), wire=wire,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    gathered = merge.torch_pairwise_merge(
        torch.from_numpy(x), torch.from_numpy(partner), torch.from_numpy(masked_alpha),
        wire=wire,
    )
    np.testing.assert_array_equal(gathered.numpy(), want)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("alpha_kind", ["0.3", "random"])
@pytest.mark.parametrize("d", [2048, 272474])
@pytest.mark.parametrize("phase", [0, 1])
def test_plain_gather_merge_bit_equal_to_reference_pull(phase, d, alpha_kind, wire):
    partner = ref_schedules._ring_pull(N, phase)
    x = np.random.default_rng(d + phase).standard_normal((N, d)).astype(np.float32)
    want, masked_alpha = _reference(x, partner, _alpha(alpha_kind, 1), "pull", wire)
    got = merge.torch_pairwise_merge(
        torch.from_numpy(x), torch.from_numpy(partner), torch.from_numpy(masked_alpha),
        wire=wire,
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_two_rounding_form_would_not_be_bit_equal():
    # Why the plain versions use addcmul: at α = 0.3 the unfused formula
    # misses the reference's last bit on a good share of elements.
    x = np.random.default_rng(5).standard_normal((N, 4096)).astype(np.float32)
    want, a = _reference(x, RING_EVEN, _alpha("0.3"), "pairwise", "f32")
    t, at = torch.from_numpy(x), torch.from_numpy(a)[:, None]
    unfused = ((1 - at) * t + at * t[torch.from_numpy(RING_EVEN)]).numpy()
    assert (unfused != want).mean() > 0.05


@pytest.mark.parametrize("d", [2048, 272474])
def test_plain_versions_agree_with_pallas_interpret(d):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, d)).astype(np.float32)
    alpha = rng.uniform(0, 1, N).astype(np.float32)
    want_gather = np.asarray(
        ref_merge.pallas_pairwise_merge(
            jnp.asarray(x), jnp.asarray(RING_ODD, jnp.int32), jnp.asarray(alpha),
            interpret=True,
        )
    )
    got_gather = merge.torch_pairwise_merge(
        torch.from_numpy(x), torch.from_numpy(RING_ODD), torch.from_numpy(alpha)
    )
    np.testing.assert_allclose(got_gather.numpy(), want_gather, rtol=3e-4, atol=1e-6)
    left, right = ref_merge.involution_pairs(WITH_FIXED, pad_to=4)
    want_pair = np.asarray(
        ref_merge.pallas_pair_merge(
            jnp.asarray(x), jnp.asarray(left), jnp.asarray(right), jnp.asarray(alpha),
            interpret=True,
        )
    )
    got_pair = merge.torch_pair_merge_(
        torch.from_numpy(x.copy()), torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(alpha),
    )
    np.testing.assert_allclose(got_pair.numpy(), want_pair, rtol=3e-4, atol=1e-6)


@pytest.mark.parametrize("wire_bf16", [False, True])
def test_pad_self_pairs_stay_bit_identical(wire_bf16):
    x = torch.randn(4, 1001, generator=torch.Generator().manual_seed(0))
    x[2, :3] = torch.tensor([float("inf"), float("nan"), -0.0])
    before = x.clone()
    alpha = torch.full((4,), 0.7)
    left, right = torch.tensor([0, 2, 2], dtype=torch.int32), torch.tensor([1, 2, 2], dtype=torch.int32)
    merge.torch_pair_merge_(
        x, left, right, alpha, wire="bf16" if wire_bf16 else "f32"
    )
    assert torch.equal(x[2:].view(torch.int32), before[2:].view(torch.int32))
    assert not torch.equal(x[:2], before[:2])


@pytest.mark.parametrize(
    "partner, pad_to",
    [
        ([1, 0, 3, 2, 5, 4, 7, 6], None),
        ([0, 1, 4, 3, 2], None),
        ([0, 1, 4, 3, 2], 2),
        ([0, 1, 4, 3, 2], 3),
        ([1, 2, 0], None),  # a 3-cycle: not an involution
        ([1, 0, 3, 2], 3),  # a perfect matching cannot pad
        ([0, 1, 4, 3, 2], 0),  # more pairs than pad_to
        ([0], None),
    ],
)
def test_involution_pairs_equal_including_errors(partner, pad_to):
    try:
        want = ref_merge.involution_pairs(partner, pad_to=pad_to)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            merge.involution_pairs(partner, pad_to=pad_to)
        return
    got = merge.involution_pairs(partner, pad_to=pad_to)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32


def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    merge.reset_launch_counts()
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((N, 777)).astype(np.float32))
    alpha = torch.from_numpy(rng.uniform(0, 1, N).astype(np.float32))
    left, right = (torch.from_numpy(v) for v in merge.involution_pairs(RING_EVEN))
    want = merge.torch_pair_merge_(x.clone(), left, right, alpha, wire="bf16")
    got = merge.pair_merge_(x.clone(), left, right, alpha, wire="bf16")
    assert torch.equal(got, want)
    partner = torch.from_numpy(RING_ODD.astype(np.int32))
    want = merge.torch_pairwise_merge(x, partner, alpha)
    assert torch.equal(merge.gather_merge(x, partner, alpha), want)
    out = torch.empty_like(x)
    assert merge.gather_merge(x, partner, alpha, out=out) is out and torch.equal(out, want)
    assert torch.equal(merge.pairwise_merge(x, torch.from_numpy(RING_ODD), alpha), want)
    assert merge.pair_merge_.launches == 0 and merge.gather_merge.launches == 0
