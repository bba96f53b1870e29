"""The port's ring, zigzag and Ulysses attention against the reference.

Inputs are made with numpy from a seed.  The reference runs under
``shard_map`` on the 8-device CPU mesh (one device per sp rank), its hops
through its jnp twins; the port runs the same ranks as a virtual axis on
the CPU, its hops through the kernels' plain versions.  Outputs and
gradients agree at the reference's own tolerance for the flash ring (rtol
2e-4 / atol 2e-5, ``tests/test_flash_ring.py``); the zigzag index maps and
positions are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dpwa_tpu.ops import flash_ring as ref_flash_ring
from dpwa_tpu.ops import zigzag_ring as ref_zigzag
from dpwa_tpu.ops.ring_attention import ring_attention_local as ref_ring_local
from dpwa_tpu.ops.ulysses import ulysses_attention_local as ref_ulysses
from dpwa_tpu.utils.compat import shard_map
from dpwa_tpu_torch.ops import flash_attention, flash_ring, zigzag_ring
from dpwa_tpu_torch.ops.flash_ring import DIAG, FULL, SKIP
from dpwa_tpu_torch.ops.ring_attention import full_attention_reference, ring_attention_local
from dpwa_tpu_torch.ops.ulysses import ulysses_attention_local

TOL = dict(rtol=2e-4, atol=2e-5)



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side at these sizes runs on one thread: the parallel
    tier-1 run shares the cores with timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkv(b, t, h, kv, d, seed=0):
    """q, k, v ``[B, T, heads, D]`` and an output cotangent, as numpy."""
    return _arrays(seed, (b, t, h, d), (b, t, kv, d), (b, t, kv, d), (b, t, h, d))


def _ref_under_sp(fn, sp, q, k, v, g):
    """The reference's ``fn(q, k, v)`` under shard_map over ``sp`` devices
    (the sequence axis sharded) and its gradients for the cotangent ``g``."""
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    spec = P(None, "sp", None, None)
    mapped = shard_map(fn, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(mapped, q, k, v)
        return (out, *vjp(g))

    return [np.asarray(x) for x in run(*map(jnp.asarray, (q, k, v, g)))]


def _port(fn, q, k, v, g):
    """``fn(q, k, v)`` in the port and its gradients for the cotangent ``g``."""
    q, k, v = (torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(g))
    return [x.detach().numpy() for x in (out, *grads)]


def _assert_all_close(got, want, tol=TOL):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)


# --- one hop ------------------------------------------------------------------


@pytest.mark.parametrize(
    "d,t,causal",
    [(16, 32, True), (16, 32, False), (128, 128, True), (128, 128, False), (16, 640, True)],
)
def test_hop_matches_reference_twins(d, t, causal):
    """``torch_hop_fwd`` / ``torch_hop_bwd`` against ``_hop_fwd_jnp`` /
    ``_hop_bwd_jnp`` on one block (layout [B, H, T, D]); T 640 crosses the
    twins' 512-row query chunk."""
    b, h = 2, 2
    q, k, v, do = _arrays(d + t, *[(b, h, t, d)] * 4)
    lse, di = _arrays(7, (b, h, t), (b, h, t))
    lse = lse + 3.0  # a global lse at least as large as a block's scores
    scale = 1.0 / (d ** 0.5)
    want_o, want_lse = ref_flash_ring._hop_fwd_jnp(*map(jnp.asarray, (q, k, v)), causal, scale)
    got_o, got_lse = flash_ring.torch_hop_fwd(*map(torch.from_numpy, (q, k, v)), causal, scale)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)
    args = (q, k, v, lse, do, di)
    want = ref_flash_ring._hop_bwd_jnp(*map(jnp.asarray, args), causal, scale)
    got = flash_ring.torch_hop_bwd(*map(torch.from_numpy, args), causal, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("kv", [4, 2])
def test_ring_hop_runs_every_rank_as_the_reference_twins(kv):
    """The wrappers' plain versions over all ranks of a hop, grouped K/V
    read per rank: rank me's rows are the twin on (its block, block
    (me − hop) mod sp), expanded to every head; a skipped rank's are 0 and
    −1e30; the backward adds each rank's share, groups folded, into the
    source block's rows."""
    b, sp, t_local, h, d = 1, 4, 16, 4, 8
    q, k, v, do = _qkv(b, sp * t_local, h, kv, d, seed=kv)
    lse, di = _arrays(9, (b, h, sp * t_local), (b, h, sp * t_local))
    lse = lse + 3.0
    hop, cases = 1, (SKIP, FULL, DIAG, FULL)
    tq = [torch.from_numpy(x) for x in (q, k, v, do, lse, di)]
    o, lse_o = flash_ring.ring_hop_fwd(*tq[:3], sp=sp, hop=hop, cases=cases)
    dq, dk, dv = (torch.zeros_like(x) for x in tq[:3])
    flash_ring.ring_hop_bwd_(*tq[:3], tq[4], tq[3], tq[5], dq, dk, dv, sp=sp, hop=hop, cases=cases)
    want_dk, want_dv = np.zeros_like(k), np.zeros_like(v)
    scale = 1.0 / (d ** 0.5)
    for me, case in enumerate(cases):
        rows = slice(me * t_local, (me + 1) * t_local)
        if case == SKIP:
            assert not o[:, rows].any() and (lse_o[:, :, rows] == -1e30).all()
            assert not dq[:, rows].any()
            continue
        src = (me - hop) % sp
        src_rows = slice(src * t_local, (src + 1) * t_local)
        qh = jnp.asarray(q[:, rows]).transpose(0, 2, 1, 3)
        kh, vh = (ref_flash_ring._expand_kv(jnp.asarray(x[:, src_rows]).transpose(0, 2, 1, 3), h)
                  for x in (k, v))
        want_o, want_l = ref_flash_ring._hop_fwd_jnp(qh, kh, vh, case == DIAG, scale)
        np.testing.assert_allclose(o[:, rows].numpy(), np.asarray(want_o).transpose(0, 2, 1, 3), **TOL)
        np.testing.assert_allclose(lse_o[:, :, rows].numpy(), np.asarray(want_l), **TOL)
        r_dq, r_dk, r_dv = ref_flash_ring._hop_bwd_jnp(
            qh, kh, vh, jnp.asarray(lse[:, :, rows]), jnp.asarray(do[:, rows]).transpose(0, 2, 1, 3),
            jnp.asarray(di[:, :, rows]), case == DIAG, scale,
        )
        np.testing.assert_allclose(dq[:, rows].numpy(), np.asarray(r_dq).transpose(0, 2, 1, 3), **TOL)
        fold = lambda x: np.asarray(x).reshape(b, kv, h // kv, t_local, d).sum(2).transpose(0, 2, 1, 3)
        want_dk[:, src_rows] += fold(r_dk)
        want_dv[:, src_rows] += fold(r_dv)
    np.testing.assert_allclose(dk.numpy(), want_dk, **TOL)
    np.testing.assert_allclose(dv.numpy(), want_dv, **TOL)


@pytest.mark.parametrize("rule", ["causal", "reverse", "full"])
@pytest.mark.parametrize("sp", [2, 4])
def test_hop_cases_follow_the_reference_conds(sp, rule):
    """A rank's case at each hop is the branch the reference's lax.cond
    takes (``flash_ring.py:317-325``, ``zigzag_ring.py:167-193``)."""
    for hop in range(sp):
        for me, case in enumerate(flash_ring.hop_cases(sp, hop, rule)):
            src = (me - hop) % sp
            if rule == "full":
                assert case == FULL
            elif src == me:
                assert case == DIAG
            else:
                skipped = src > me if rule == "causal" else src < me
                assert case == (SKIP if skipped else FULL)


def test_hop_wrappers_reject_bad_panels():
    q = torch.zeros(1, 64, 2, 8)
    with pytest.raises(ValueError, match="divisible"):
        flash_ring.ring_hop_fwd(q[:, :63], q[:, :63], q[:, :63], sp=4, hop=0, cases=(DIAG,) * 4)
    with pytest.raises(ValueError, match="hop"):
        flash_ring.ring_hop_fwd(q, q, q, sp=4, hop=4, cases=(DIAG,) * 4)
    with pytest.raises(ValueError, match="cases"):
        flash_ring.ring_hop_fwd(q, q, q, sp=4, hop=0, cases=(DIAG,) * 3)
    with pytest.raises(ValueError, match="exceed"):
        flash_ring.ring_hop_fwd(q, q, q, sp=4, hop=0, cases=(FULL,) * 4, rows=8, q_off=12)
    with pytest.raises(ValueError, match="causal"):
        flash_ring.hop_plan("zigzag", 16, causal=False)


# --- the ring -----------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4])
def test_flash_ring_matches_reference(sp, causal):
    """``ring_flash_attention`` (its plain hops) against the reference's
    ``ring_flash_attention_local`` (its twins), GQA, with gradients."""
    q, k, v, g = _qkv(2, 64, 4, 2, 16, seed=sp)
    want = _ref_under_sp(
        lambda a, b, c: ref_flash_ring.ring_flash_attention_local(a, b, c, "sp", causal, "jnp"),
        sp, q, k, v, g,
    )
    got = _port(lambda a, b, c: flash_ring.ring_flash_attention(a, b, c, sp, causal), q, k, v, g)
    _assert_all_close(got, want)


@pytest.mark.parametrize(
    "sp,causal,impl",
    [(2, True, "auto"), (2, False, "auto"), (4, True, "auto"), (4, False, "auto"),
     (4, True, "flash")],
)
def test_ring_attention_local_matches_reference(sp, causal, impl):
    """``ring_attention_local``'s dispatch on the CPU as the reference's
    off the TPU: "auto" the einsum ring, "flash" the flash ring."""
    q, k, v, g = _qkv(1, 64, 4, 2, 16, seed=10 + sp)
    want = _ref_under_sp(
        lambda a, b, c: ref_ring_local(a, b, c, "sp", causal, impl=impl), sp, q, k, v, g
    )
    got = _port(lambda a, b, c: ring_attention_local(a, b, c, sp, causal, impl=impl), q, k, v, g)
    _assert_all_close(got, want)


def test_einsum_ring_chunks_long_blocks():
    """Blocks over 512 rows run the einsum hop in 256-row query chunks,
    as the reference's ``_auto_q_chunk`` picks."""
    q, k, v, g = _qkv(1, 1152, 2, 1, 8, seed=3)
    want = _ref_under_sp(lambda a, b, c: ref_ring_local(a, b, c, "sp", True, impl="xla"),
                         2, q, k, v, g)
    got = _port(lambda a, b, c: ring_attention_local(a, b, c, 2, True, impl="xla"), q, k, v, g)
    _assert_all_close(got, want)
    got_full = full_attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got_full.numpy(), want[0], **TOL)


# --- zigzag -------------------------------------------------------------------


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_zigzag_maps_and_positions_bit_equal(sp):
    assert zigzag_ring.zigzag_order(sp) == ref_zigzag.zigzag_order(sp)
    x = np.arange(2 * 48 * 3).reshape(2, 48, 3)
    got = zigzag_ring.zigzag_shard(torch.from_numpy(x), sp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_zigzag.zigzag_shard(jnp.asarray(x), sp)))
    back = zigzag_ring.zigzag_unshard(got, sp)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_zigzag.zigzag_unshard(jnp.asarray(got.numpy()), sp))
    )
    np.testing.assert_array_equal(back.numpy(), x)
    t_local = 48 // sp
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    ref_pos = shard_map(
        lambda _: ref_zigzag.zigzag_positions_local(t_local, "sp"),
        mesh=mesh, in_specs=P("sp"), out_specs=P("sp"),
    )(jnp.zeros(sp))
    port_pos = torch.cat([zigzag_ring.zigzag_positions_local(t_local, sp, r) for r in range(sp)])
    np.testing.assert_array_equal(port_pos.numpy(), np.asarray(ref_pos))
    np.testing.assert_array_equal(zigzag_ring.zigzag_positions(48, sp).numpy(), np.asarray(ref_pos))
    with pytest.raises(ValueError, match="divisible"):
        zigzag_ring.zigzag_shard(torch.zeros(1, 50, 1), 4)


@pytest.mark.parametrize("sp,kv", [(2, 4), (4, 1)])
def test_zigzag_ring_matches_reference(sp, kv):
    """The zigzag ring (three panels a hop) and its gradients against
    ``zigzag_ring_attention_local`` on zigzag-sharded inputs."""
    q, k, v, g = (ref_zigzag.zigzag_shard(jnp.asarray(x), sp) for x in _qkv(1, 64, 4, kv, 16, seed=sp))
    q, k, v, g = (np.asarray(x) for x in (q, k, v, g))
    want = _ref_under_sp(
        lambda a, b, c: ref_zigzag.zigzag_ring_attention_local(a, b, c, "sp", "jnp"), sp, q, k, v, g
    )
    q, k, v, g = (x.copy() for x in (q, k, v, g))
    got = _port(lambda a, b, c: zigzag_ring.zigzag_ring_attention(a, b, c, sp), q, k, v, g)
    _assert_all_close(got, want)


# --- Ulysses ------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("kv", [2, 1])
def test_ulysses_matches_reference(kv, impl):
    """Ulysses at sp 2, grouped K/V sharded (KV 2) or expanded first (KV 1,
    ``KV % sp != 0``), with gradients.  The reference runs its dense
    per-rank attention (its flash branch is TPU-only); the port's "flash"
    runs B5's plain version per rank."""
    q, k, v, g = _qkv(2, 32, 4, kv, 8, seed=kv)
    want = _ref_under_sp(lambda a, b, c: ref_ulysses(a, b, c, "sp", True), 2, q, k, v, g)
    flash_attention.reset_launch_counts()
    got = _port(lambda a, b, c: ulysses_attention_local(a, b, c, 2, True, impl=impl), q, k, v, g)
    _assert_all_close(got, want, dict(rtol=2e-5, atol=2e-6))
    assert flash_attention.flash_attn_fwd.launches == 0
    with pytest.raises(ValueError, match="divisible by sp"):
        ulysses_attention_local(*map(torch.from_numpy, (q, k, v)), 3)
