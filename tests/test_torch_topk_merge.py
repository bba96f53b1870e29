"""B2's top-k form (``ops.merge.topk_merge``, one launch a merged top-k or
shard-top-k round) on the CPU, where it runs its plain version.

The plain version is held bit for bit (NaN for NaN) against the two-launch
route it replaced (B2's self-lerp, then ``torch_support_merge_``; for a
shard frame on a copy of the row), and against the reference: its host
merge of the densified frame (``native.merge_out``, the transport's) at α
0.3, 0.5 and 0.7, and its device engine's ``build_topk`` /
``build_shard_topk`` off the support and, on it, wherever that XLA fuses
the same product.  The edges: k = 1 and k = d, indices at 0, d − 1 and on
both sides of the kernel's 4096-float tile boundary, inf and NaN in the
row and in the values, the first and last shard of a partition with d %
k ≠ 0.  The engine's top-k merges give the results they gave before, and
a TCP pair on a top-k wire makes one top-k merge a merged round.
"""

import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpwa_tpu.device import kernels as ref_kernels
from dpwa_tpu.native import merge_out
from dpwa_tpu_torch.device import engine
from dpwa_tpu_torch.ops import merge
from dpwa_tpu_torch.ops import quantize as q
from dpwa_tpu_torch.ops import shard
from dpwa_tpu_torch.parallel import protocol_constants as pc
from tests.torch_codec_groups import assert_support_matches_device_engine, run_group

TILE = 4096  # csrc/merge.cu's kTile
ALPHAS = (0.3, 0.5, 0.7)


@pytest.fixture(autouse=True)
def _socket_timeout():
    prev = socket.getdefaulttimeout()
    socket.setdefaulttimeout(10.0)
    try:
        yield
    finally:
        socket.setdefaulttimeout(prev)


def _bits(t) -> np.ndarray:
    return np.asarray(t, np.float32).view(np.int32)


def _same(got, want) -> bool:
    """Bit-equal, any NaN equal to any NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(got) & np.isnan(want)
    return bool(np.all((_bits(got) == _bits(want)) | nan))


def _support(n: int, case: str, rng) -> np.ndarray:
    """Sorted, unique slice positions for an edge case of the support."""
    if case == "one":
        return np.array([rng.integers(n)], np.int64)
    if case == "all":
        return np.arange(n, dtype=np.int64)
    if case == "ends":  # 0, n − 1 and both sides of each tile boundary
        edges = [0, n - 1] + [e + o for e in range(TILE, n, TILE) for o in (-2, -1, 0, 1)]
        extra = rng.choice(n, n // 20, replace=False)
        return np.unique(np.concatenate([edges, extra]).clip(0, n - 1)).astype(np.int64)
    return np.sort(rng.choice(n, n // 20, replace=False)).astype(np.int64)


def _inputs(d: int, case: str, seed: int = 0, special: bool = True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(d).astype(np.float32)
    idx = _support(d, case, rng)
    v = rng.standard_normal(idx.size).astype(np.float32)
    if special:
        x[[1, d // 2, d - 2]] = [np.inf, np.nan, -np.inf]
        v[: min(3, v.size)] = [np.nan, np.inf, -np.inf][: min(3, v.size)]
        if idx.size > 4:
            x[idx[3]] = np.nan
    return x, idx, v


def _two_launch(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor, alpha: float,
                lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """The route ``topk_merge`` replaced: a copy of the row for a slice, B2's
    self-lerp of the slice, then the support form."""
    hi = x.numel() if hi is None else hi
    out = x.clone()
    sl = x[lo:hi]
    a = torch.tensor([alpha], dtype=torch.float32)
    out[lo:hi] = merge.gather_merge(sl[None], torch.zeros(1, dtype=torch.int32), a,
                                    wire="int8", lerp_self=True)[0]
    merge.torch_support_merge_(out[lo:hi], sl, idx, v, alpha)
    return out


@pytest.mark.parametrize("d,case", [(1, "one"), (7, "all"), (3 * TILE + 5, "ends"),
                                    (2 * TILE, "all"), (10_003, "random")])
def test_plain_topk_merge_bit_equal_to_self_lerp_then_support(d, case):
    x, idx, v = _inputs(d, case, special=d > 4)
    xt, it, vt = torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(v)
    merge.reset_launch_counts()
    for alpha in ALPHAS:
        got = merge.topk_merge(xt, it, vt, alpha)
        assert _same(got, _two_launch(xt, it, vt, alpha)), alpha
        assert _same(got, merge.torch_topk_merge(xt, it.to(torch.int32), vt, alpha)), alpha
    assert merge.topk_merge.launches == 0  # the CPU runs the plain version


@pytest.mark.parametrize("which", ["first", "last"])
@pytest.mark.parametrize("case", ["ends", "all"])
def test_plain_sliced_topk_merge_equals_clone_plus_slice_merge(which, case):
    """A shard frame's slice of a 4-way partition with d % 4 = 3: the other
    slices bit-identical (inf and NaN among them), the slice as the
    two-launch route merges it."""
    d, k = 4 * TILE + 3, 4
    i = 0 if which == "first" else k - 1
    lo, hi = shard.shard_bounds(d, k, i)
    x, idx, v = _inputs(hi - lo, case, seed=i)
    rest = np.random.default_rng(9).standard_normal(d).astype(np.float32)
    rest[[0, d - 1]] = [np.nan, np.inf]
    rest[lo:hi] = x
    xt, it, vt = torch.from_numpy(rest), torch.from_numpy(idx), torch.from_numpy(v)
    for alpha in ALPHAS:
        got = merge.topk_merge(xt, it, vt, alpha, lo, hi)
        assert _same(got, _two_launch(xt, it, vt, alpha, lo, hi)), alpha
        assert _bits(got[:lo]).tolist() == _bits(rest[:lo]).tolist()
        assert _bits(got[hi:]).tolist() == _bits(rest[hi:]).tolist()


@pytest.mark.parametrize("d,case", [(5, "all"), (3 * TILE + 5, "ends"), (6001, "random")])
def test_topk_merge_bit_equal_to_reference_merges(d, case):
    """Against the reference's host merge of the densified frame, bit for
    bit, and its device engine's ``build_topk`` as the helper says."""
    x, idx, v = _inputs(d, case, seed=d, special=False)
    for alpha in ALPHAS:
        dense = x.copy()
        dense[idx] = v
        host = merge_out(x, dense, alpha)
        device = np.asarray(ref_kernels.build_topk(d, idx.size)(
            jnp.asarray(x), jnp.asarray(idx.astype(np.int32)), jnp.asarray(v), np.float32(alpha)))
        got = merge.topk_merge(torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(v),
                               alpha).numpy()
        assert np.array_equal(_bits(got), _bits(host)), alpha
        assert_support_matches_device_engine(got, device, x, idx, v, alpha)


def test_topk_merge_special_values_as_the_reference_host_merge():
    """inf and NaN in the row and in the shipped values: NaN where the
    reference's host merge gives NaN, the same bits elsewhere."""
    x, idx, v = _inputs(3 * TILE + 5, "ends", seed=5)
    for alpha in ALPHAS:
        dense = x.copy()
        dense[idx] = v
        got = merge.topk_merge(torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(v),
                               alpha)
        assert _same(got, merge_out(x, dense, alpha)), alpha
        assert np.isnan(got.numpy()).sum() == np.isnan(merge_out(x, dense, alpha)).sum()


@pytest.mark.parametrize("which", ["first", "last"])
def test_shard_topk_merge_bit_equal_to_reference_merges(which):
    """A shard frame's merge against the reference's host merge of the slice
    and its ``build_shard_topk``, first and last shard of 3 with d % 3 = 2."""
    d, k = 2 * TILE + 2, 3
    i = 0 if which == "first" else k - 1
    lo, hi = shard.shard_bounds(d, k, i)
    rng = np.random.default_rng(i)
    x = rng.standard_normal(d).astype(np.float32)
    idx = _support(hi - lo, "ends", rng)
    v = rng.standard_normal(idx.size).astype(np.float32)
    for alpha in ALPHAS:
        host = x.copy()
        dense = x[lo:hi].copy()
        dense[idx] = v
        host[lo:hi] = merge_out(np.ascontiguousarray(x[lo:hi]), dense, alpha)
        device = ref_kernels.build_shard_topk(d, hi - lo, idx.size)(
            jnp.asarray(x), jnp.asarray(idx.astype(np.int32)), jnp.asarray(v), np.int32(lo),
            np.float32(alpha))
        got = merge.topk_merge(torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(v),
                               alpha, lo, hi).numpy()
        assert np.array_equal(_bits(got), _bits(host)), alpha
        assert_support_matches_device_engine(got, np.asarray(device), x, lo + idx, v, alpha)


def test_engine_topk_merges_unchanged_on_cpu():
    """``merge_topk`` / ``merge_shard_topk`` give the two-launch route's
    results, each counted once as a top-k merge."""
    d = 2 * TILE + 7
    x, idx, v = _inputs(d, "ends", seed=3)
    xt = torch.from_numpy(x)
    engine.reset_stats()
    payload = q.TopkPayload(d, torch.from_numpy(idx), torch.from_numpy(v))
    got = engine.merge(xt, payload, 0.3)
    assert _same(got, _two_launch(xt, payload.indices, payload.values, 0.3))
    assert _same(engine.merge_topk(xt, payload, 0.3), got)
    lo, hi = shard.shard_bounds(d, 2, 1)
    sidx = torch.from_numpy(_support(hi - lo, "ends", np.random.default_rng(1)))
    inner = q.TopkPayload(hi - lo, sidx, torch.linspace(-2.0, 2.0, sidx.numel()))
    body = shard.ShardPayload(d, 2, 1, pc.PAYLOAD_TOPK_DELTA, inner)
    sgot = engine.merge(xt, body, 0.7)
    assert _same(sgot, _two_launch(xt, inner.indices, inner.values, 0.7, lo, hi))
    assert _same(engine.merge_shard_topk(xt, body, 0.7), sgot)
    assert engine.stats()["topk_merges"] == 4
    with pytest.raises(ValueError):
        engine.merge_shard_topk(xt[:-1], body, 0.7)


def test_topk_merge_wrapper_contract():
    """The wrapper's plain route is chosen by the tensor's device alone; on
    another device it raises; the launch count is reset with the others."""
    x = torch.arange(8, dtype=torch.float32)
    idx, v = torch.tensor([0, 5]), torch.tensor([1.5, -2.0])
    merge.topk_merge.launches = 3
    merge.reset_launch_counts()
    assert merge.topk_merge.launches == 0
    out = merge.topk_merge(x, idx, v, 0.5, 2, 8)
    assert out.data_ptr() != x.data_ptr()
    assert out.tolist() == [0.0, 1.0, 1.75, 3.0, 4.0, 5.0, 6.0, 2.5]
    with pytest.raises(ValueError, match="unsupported device"):
        merge.topk_merge(x.to("meta"), idx, v, 0.5)


def test_topk_pair_makes_one_topk_merge_a_merged_round():
    """Two port nodes on a top-k wire and two on shard k 2 with a top-k
    inner, lock-step: one top-k merge for each merged round."""
    for kw in (dict(wire_codec="topk", topk_fraction=0.1),
               dict(wire_codec="topk", topk_fraction=0.1, shard={"k": 2})):
        engine.reset_stats()
        log, _ = run_group(("port", "port"), rounds=4, d=500, **kw)
        merged = sum(1 for entry in log if entry[3] == "success")
        assert merged > 0 and engine.stats()["topk_merges"] == merged, kw
