"""The port's CUDA kernels and train step on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the reference package, so it also runs on a machine that
has only PyTorch; there, skip the repository's ``conftest.py`` (which sets
up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

The merge kernels are held bit for bit against their plain versions on a
CPU copy of the same inputs; the flash-attention kernels (B5) and the ring
hops (B3, B4) against their plain versions on the card (TF32 off), within a
stated tolerance; the train steps on the card against the same steps on the
CPU (TF32 off).
"""

import numpy as np
import pytest
import torch

from dpwa_tpu_torch import checkpoint, train_sp
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.models import bert, llama, mnist, resnet
from dpwa_tpu_torch.ops import flash_attention, flash_ring, merge
from dpwa_tpu_torch.optim import adam, adamw, lora_optimizer, sgd
from dpwa_tpu_torch.parallel import stacked
from dpwa_tpu_torch.utils import prng
from dpwa_tpu_torch.train import (
    init_params_per_peer,
    softmax_cross_entropy_with_integer_labels,
    stack_params,
)

N = 8
RING_ODD = np.array([7, 2, 1, 4, 3, 6, 5, 0])
WITH_FIXED = np.array([1, 0, 2, 3, 5, 4, 6, 7])

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("wire_bf16", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "padded", "offset"])
def test_kernels_bit_equal_to_plain(cuda_device, layout, wire_bf16):
    wire = "bf16" if wire_bf16 else "f32"
    d = 272474
    gen = torch.Generator().manual_seed(4)
    base = torch.randn(N, d, generator=gen)
    alpha = torch.rand(N, generator=gen)

    def on_card(cpu):
        if layout == "contiguous":
            return cpu.to(cuda_device)
        lead = 3 if layout == "offset" else 0
        buf = torch.zeros(N, d + lead + 29, device=cuda_device)
        view = buf[:, lead:lead + d]
        view.copy_(cpu)
        return view

    merge.reset_launch_counts()
    left, right = (torch.from_numpy(v) for v in merge.involution_pairs(WITH_FIXED, pad_to=4))
    x = on_card(base)
    merge.pair_merge_(x, left.to(cuda_device), right.to(cuda_device),
                      alpha.to(cuda_device), wire=wire)
    want = merge.torch_pair_merge_(base.clone(), left, right, alpha, wire=wire)
    assert torch.equal(x.cpu(), want)
    partner = torch.from_numpy(RING_ODD.astype(np.int32))
    got = merge.gather_merge(on_card(base), partner.to(cuda_device),
                             alpha.to(cuda_device), wire=wire)
    want = merge.torch_pairwise_merge(base, partner, alpha, wire=wire)
    assert torch.equal(got.cpu(), want)
    assert merge.pair_merge_.launches == 1 and merge.gather_merge.launches == 1


@pytest.mark.parametrize("wire_bf16", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "offset"])
def test_pair_merge_self_pairs_bit_equal_to_plain(cuda_device, layout, wire_bf16):
    """B1 as the stacked exchange calls it: the rows that sit the round out
    listed as self-pairs at α = 0 and merged with themselves, so their inf
    and NaN come out NaN.  Equal to the plain version bit for bit, except
    that a NaN may carry another payload on the card."""
    wire = "bf16" if wire_bf16 else "f32"
    d = 4099
    gen = torch.Generator().manual_seed(5)
    base = torch.randn(N, d, generator=gen)
    alpha = torch.rand(N, generator=gen)
    fixed = np.flatnonzero(WITH_FIXED == np.arange(N))
    alpha[fixed] = 0.0
    bad = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0, 3.0e38])
    base[fixed, :5] = bad
    base[fixed, -5:] = bad
    lead = 3 if layout == "offset" else 0
    buf = torch.zeros(N, d + lead + 29, device=cuda_device)
    x = buf[:, lead:lead + d]
    x.copy_(base)
    left, right = (torch.from_numpy(v) for v in merge.involution_pairs(WITH_FIXED, self_pairs=True))
    merge.reset_launch_counts()
    merge.pair_merge_(x, left.to(cuda_device), right.to(cuda_device), alpha.to(cuda_device),
                      wire=wire, self_pairs=True)
    want = merge.torch_pair_merge_(base.clone(), left, right, alpha,
                                   wire=wire, self_pairs=True)
    got = x.cpu()
    both_nan = got.isnan() & want.isnan()
    assert bool(((got.view(torch.int32) == want.view(torch.int32)) | both_nan).all())
    assert bool(got[fixed][:, :3].isnan().all()) and bool(got[fixed][:, -5:-2].isnan().all())
    assert merge.pair_merge_.launches == 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device)
    idx = torch.tensor([0, 2], dtype=torch.int32, device=cuda_device)
    alpha = torch.zeros(4, device=cuda_device)
    with pytest.raises(TypeError):
        merge.pair_merge_(x.double(), idx, idx + 1, alpha.double())
    with pytest.raises(ValueError):
        merge.pair_merge_(x.t(), idx, idx + 1, alpha)
    with pytest.raises(ValueError):
        merge.pair_merge_(x, idx.long(), idx + 1, alpha)
    with pytest.raises(ValueError):
        merge.gather_merge(x, idx, alpha)
    with pytest.raises(ValueError):
        merge.gather_merge(x, idx.cpu(), alpha)
    with pytest.raises(ValueError, match="overlap"):
        merge.pair_merge_(torch.zeros(1, 8, device=cuda_device).expand(4, 8), idx, idx + 1, alpha)
    partner = torch.arange(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="storage"):
        merge.gather_merge(x, partner, alpha, out=x)


@pytest.mark.parametrize("mode", ["pairwise", "pull"])
def test_train_step_on_card_matches_cpu(cuda_device, mode):
    """Three steps of a 4-peer ResNet-8 on the card (every exchange through
    B1 or B2) and on the CPU (the plain merges), from the same parameters
    and batches.  TF32 is off, so only the order of sums differs: losses
    rtol 1e-4, parameters rtol 1e-3 / atol 1e-4."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, steps = 4, 3
    rng = np.random.default_rng(0)
    batches = [
        (torch.from_numpy(rng.random((n, 8, 32, 32, 3), np.float32)),
         torch.from_numpy(rng.integers(0, 10, (n, 8)).astype(np.int32)))
        for _ in range(steps)
    ]
    results = []
    for device in ("cpu", cuda_device):
        model = resnet.CifarResNet(depth=8).to(device)
        cfg = make_local_config(n, mode=mode, interpolation="loss", factor=0.9)
        t = stacked.StackedTransport(cfg, device=device)
        opt = sgd(0.1, momentum=0.9)

        def loss_fn(params, batch):
            logits = torch.func.functional_call(model, params, (batch[0],))
            return softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean()

        params = init_params_per_peer(
            lambda k: resnet.init(model, k), prng.key(0), n, device
        )
        state = stacked.init_stacked_state(params, opt, t)
        step = stacked.make_stacked_train_step(loss_fn, opt, t)
        merge.reset_launch_counts()
        losses = []
        for x, y in batches:
            state, loss, _ = step(state, (x.to(device), y.to(device)))
            losses.append(loss.cpu())
        launches = merge.pair_merge_.launches + merge.gather_merge.launches
        results.append((torch.stack(losses), state.params.flat.cpu(), launches))
    (cpu_l, cpu_p, cpu_launches), (gpu_l, gpu_p, gpu_launches) = results
    assert cpu_launches == 0 and gpu_launches == steps
    torch.testing.assert_close(gpu_l, cpu_l, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gpu_p, cpu_p, rtol=1e-3, atol=1e-4)


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute difference over the larger of 1 and the
    largest magnitude of ``want``: the normwise error ``chip_smoke.py``
    also states."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


FWD_TOL, BWD_TOL = 1e-5, 1e-4


@pytest.mark.parametrize("kv", [4, 1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 384])
def test_flash_attention_kernels_match_plain(cuda_device, t, causal, kv):
    """B5's forward (o, lse) and backward (dq, dk, dv) against the plain
    versions on the same card tensors, TF32 off: normwise error (max |Δ| /
    max(1, max |plain|)) at most 1e-5 forward and 1e-4 backward — the two
    sum in different orders, and the backward's Δ = rowsum(dO∘O) cancels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(t + kv)
    b, h, d = 2, 4, 128
    q, do = (torch.randn(b, t, h, d, generator=gen).to(cuda_device) for _ in range(2))
    k, v = (torch.randn(b, t, kv, d, generator=gen).to(cuda_device) for _ in range(2))
    flash_attention.reset_launch_counts()
    o, lse = flash_attention.flash_attn_fwd(q, k, v, causal=causal)
    grads = flash_attention.flash_attn_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    want_o, want_lse = flash_attention.torch_flash_attn_fwd(q, k, v, causal=causal)
    assert max_rel_err(o, want_o) <= FWD_TOL
    assert max_rel_err(lse, want_lse) <= FWD_TOL
    want = flash_attention.torch_flash_attn_bwd(q, k, v, want_o, want_lse, do, causal=causal)
    for got, ref in zip(grads, want):
        assert got.shape == ref.shape
        assert max_rel_err(got, ref) <= BWD_TOL
    assert flash_attention.flash_attn_fwd.launches == 1
    assert flash_attention.flash_attn_bwd.launches == 1


@pytest.mark.parametrize("t,q_scale,causal,kv", [
    (384, 8.0, True, 4), (384, 8.0, False, 1), (2048, 1.0, True, 1),
])
def test_flash_attention_backward_on_stressed_inputs(cuda_device, t, q_scale, causal, kv):
    """B5's backward, whose products run on the tensor cores in 3xTF32,
    on inputs that stress the split of each operand into a TF32 big part
    and remainder: q scaled by 8 (scores eight times larger, a softmax
    nearly one-hot) and the Llama path's T 2048.  Against the plain
    backward on the same card tensors, TF32 off, at the same normwise
    ``BWD_TOL`` (one TF32 product per float32 one would miss it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(t + kv + int(q_scale))
    b, h, d = 2, 4, 128
    q, do = (torch.randn(b, t, h, d, generator=gen).to(cuda_device) for _ in range(2))
    q = q * q_scale
    k, v = (torch.randn(b, t, kv, d, generator=gen).to(cuda_device) for _ in range(2))
    o, lse = flash_attention.torch_flash_attn_fwd(q, k, v, causal=causal)
    flash_attention.reset_launch_counts()
    grads = flash_attention.flash_attn_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention.torch_flash_attn_bwd(q, k, v, o, lse, do, causal=causal)
    for got, ref in zip(grads, want):
        assert max_rel_err(got, ref) <= BWD_TOL
    assert flash_attention.flash_attn_bwd.launches == 1


@pytest.mark.parametrize("t,q_scale,causal,kv", [
    (384, 8.0, True, 4), (384, 8.0, False, 1), (2048, 8.0, True, 2), (2048, 1.0, False, 4),
])
def test_flash_attention_forward_on_stressed_inputs(cuda_device, t, q_scale, causal, kv):
    """B5's forward, whose products run on the tensor cores in 3xTF32, with
    q scaled by 8 (scores in the hundreds before the scale, a softmax
    nearly one-hot) and at the Llama path's T 2048, against the plain
    forward on the same card tensors, TF32 off, at ``FWD_TOL``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(t + kv + int(q_scale) + causal)
    b, h, d = 2, 4, 128
    q = torch.randn(b, t, h, d, generator=gen).to(cuda_device) * q_scale
    k, v = (torch.randn(b, t, kv, d, generator=gen).to(cuda_device) for _ in range(2))
    flash_attention.reset_launch_counts()
    o, lse = flash_attention.flash_attn_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want_o, want_lse = flash_attention.torch_flash_attn_fwd(q, k, v, causal=causal)
    assert max_rel_err(o, want_o) <= FWD_TOL
    assert max_rel_err(lse, want_lse) <= FWD_TOL
    assert flash_attention.flash_attn_fwd.launches == 1


@pytest.mark.parametrize("case", ["bf16", "d256"])
def test_auto_runs_dense_where_b5_does_not_take_the_input(cuda_device, case):
    """``single_device_attention(impl="auto")`` on card tensors that B5
    does not take (bf16 q, k, v; head dim 256) runs the dense branch
    without error and without a launch; ``impl="flash"`` raises there."""
    from dpwa_tpu_torch.ops import ulysses

    gen = torch.Generator().manual_seed(9)
    d, dtype = (256, torch.float32) if case == "d256" else (128, torch.bfloat16)
    q = torch.randn(2, 256, 4, d, generator=gen).to(cuda_device, dtype)
    k, v = (torch.randn(2, 256, 2, d, generator=gen).to(cuda_device, dtype) for _ in range(2))
    assert not flash_attention.flash_supported(q, k, v)
    flash_attention.reset_launch_counts()
    out = ulysses.single_device_attention(q, k, v, causal=True, impl="auto")
    torch.cuda.synchronize()
    assert torch.equal(out, ulysses.dense_attention(q, k, v, causal=True))
    assert out.dtype == dtype and flash_attention.flash_attn_fwd.launches == 0
    with pytest.raises((TypeError, ValueError)):
        ulysses.single_device_attention(q, k, v, causal=True, impl="flash")


@pytest.mark.parametrize("model_name", ["resnet8", "llama_tiny"])
def test_init_on_card_matches_cpu(cuda_device, model_name):
    """A model's initialisation from the reference's draws (threefry,
    erfinv and log1p in int64 and float32 torch arithmetic) made on the
    card against the same one made on the CPU: every value within 2
    float32 ulps (the two devices' exp, log and sqrt differ in rounding)."""
    if model_name == "resnet8":
        model = resnet.CifarResNet(depth=8)
        init = lambda device: resnet.init(model, prng.key(0), device)
    else:
        model = llama.Llama(llama.LlamaConfig(**LLAMA_KW))
        init = lambda device: llama.init(model, prng.key(0), device)
    cpu, card = init("cpu"), init(cuda_device)
    for name, want in cpu.items():
        got = card[name].cpu()
        assert got.shape == want.shape and got.device.type == "cpu"
        a, b = (x.view(torch.int32).long() for x in (got, want))
        a = torch.where(a < 0, -(a & 0x7FFFFFFF), a)
        b = torch.where(b < 0, -(b & 0x7FFFFFFF), b)
        assert int((a - b).abs().max()) <= 2, name


def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 128, 4, 128, device=cuda_device)
    k = torch.zeros(1, 128, 2, 128, device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention.flash_attn_fwd(q.double(), k, k, causal=True)
    with pytest.raises(ValueError):
        flash_attention.flash_attn_fwd(q, k.cpu(), k, causal=True)
    with pytest.raises(ValueError, match="multiple of 128"):
        flash_attention.flash_attn_fwd(q[:, :64], k[:, :64], k[:, :64], causal=True)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attn_fwd(q[..., :32], k[..., :32], k[..., :32], causal=True)


LLAMA_KW = dict(
    vocab_size=512, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
    d_ff=384, max_seq_len=128, lora_rank=4,
)


def test_llama_lora_step_on_card_matches_cpu(cuda_device):
    """Three steps of a 2-peer LoRA fine-tune at head_dim 128, T 128: on
    the card (attention through B5, the exchange through B1) and on the CPU
    (the dense attention, the plain merge), from the same parameters and
    batches, TF32 off.  Losses within rtol 1e-4; LoRA leaves within rtol
    1e-3 / atol 1e-5 on 99 % of their elements and atol 1e-4 on all (Adam
    takes steps of size lr whatever the gradient's size, so a gradient that
    nearly cancels moves its element by lr times its relative error); the
    frozen leaves bit-identical to where they started."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, steps = 2, 3
    model = llama.Llama(llama.LlamaConfig(**LLAMA_KW))
    init = llama.init(model, prng.key(0))
    gen = torch.Generator().manual_seed(1)
    params = {
        k: torch.stack([v, v + 0.01 * torch.randn(v.shape, generator=gen)])
        for k, v in init.items()
    }
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(steps):
        toks = rng.integers(0, LLAMA_KW["vocab_size"], (n, 1, 129))
        batches.append((torch.from_numpy(toks[..., :-1]), torch.from_numpy(toks[..., 1:])))
    results = []
    for device in ("cpu", cuda_device):
        cfg = make_local_config(n, schedule="random", pool_size=16)
        t = stacked.StackedTransport(cfg, device=device)
        opt = lora_optimizer(adam(1e-3), llama.lora_filter)

        def loss_fn(p, batch):
            logits = llama.apply(model, p, batch[0])
            return softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean()

        state = stacked.init_stacked_state(params, opt, t)
        step = stacked.make_stacked_train_step(
            loss_fn, opt, t, exchange_filter=llama.lora_filter
        )
        merge.reset_launch_counts()
        flash_attention.reset_launch_counts()
        losses = []
        for x, y in batches:
            state, loss, _ = step(state, (x.to(device), y.to(device)))
            losses.append(loss.cpu())
        launches = (
            flash_attention.flash_attn_fwd.launches,
            flash_attention.flash_attn_bwd.launches,
            merge.pair_merge_.launches,
        )
        views = {k: v.cpu() for k, v in state.params.views().items()}
        results.append((torch.stack(losses), views, launches))
    (cpu_l, cpu_p, cpu_n), (gpu_l, gpu_p, gpu_n) = results
    assert cpu_n == (0, 0, 0)
    assert gpu_n == (LLAMA_KW["n_layers"] * steps, LLAMA_KW["n_layers"] * steps, steps)
    torch.testing.assert_close(gpu_l, cpu_l, rtol=1e-4, atol=1e-6)
    for name, want in cpu_p.items():
        got = gpu_p[name]
        if llama.lora_filter(name):
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
            loose = (got - want).abs() > 1e-5 + 1e-3 * want.abs()
            assert loose.float().mean().item() < 0.01
        else:
            assert torch.equal(got, params[name]) and torch.equal(want, params[name])


RING_PLANS = {  # name: (layout, causal)
    "contiguous": ("contiguous", True), "non_causal": ("contiguous", False),
    "zigzag": ("zigzag", True),
}


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("plan", list(RING_PLANS))
def test_ring_hop_kernels_match_plain(cuda_device, plan, kv):
    """B3 and B4 for every hop and panel of a 4-rank ring (the contiguous
    causal ring's skip, diag and full ranks; the non-causal ring; the zigzag
    ring's three half-stripe panels), against their plain versions on the
    same card tensors, TF32 off: normwise 1e-5 forward and 1e-4 backward,
    as B5.  A skipped rank writes (0, -1e30) and adds nothing; B4 adds into
    accumulators that start non-zero."""
    torch.backends.cuda.matmul.allow_tf32 = False
    layout, causal = RING_PLANS[plan]
    sp, t_local, b, h, d = 4, 256, 1, 4, 128
    gen = torch.Generator().manual_seed(kv)
    q, do = (torch.randn(b, sp * t_local, h, d, generator=gen).to(cuda_device) for _ in range(2))
    k, v = (torch.randn(b, sp * t_local, kv, d, generator=gen).to(cuda_device) for _ in range(2))
    out32, lse = flash_ring.ring_forward(q, k, v, sp, layout, causal, impl="jnp")
    di = (out32 * do).sum(-1).transpose(1, 2).contiguous()
    stripes, panels = flash_ring.hop_plan(layout, t_local, causal)
    flash_ring.reset_launch_counts()
    n = 0
    for hop in range(sp):
        for stripe, k_off, rule in panels:
            q_off, rows = stripes[stripe]
            kw = dict(sp=sp, hop=hop, cases=flash_ring.hop_cases(sp, hop, rule), rows=rows,
                      q_off=q_off, k_off=k_off)
            o, l = flash_ring.ring_hop_fwd(q, k, v, **kw)
            want_o, want_l = flash_ring.torch_ring_hop_fwd(q, k, v, **kw)
            skipped = want_l == flash_ring.NEG_INF
            assert torch.equal(l[skipped], want_l[skipped])
            assert max_rel_err(o, want_o) <= FWD_TOL
            assert max_rel_err(l[~skipped], want_l[~skipped]) <= FWD_TOL
            start = [torch.randn(x.shape, generator=gen).to(cuda_device) for x in (q, k, v)]
            got, want = [x.clone() for x in start], [x.clone() for x in start]
            flash_ring.ring_hop_bwd_(q, k, v, lse, do, di, *got, **kw)
            flash_ring.torch_ring_hop_bwd_(q, k, v, lse, do, di, *want, **kw)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert max_rel_err(g, w) <= BWD_TOL
            n += 1
    assert flash_ring.ring_hop_fwd.launches == n and flash_ring.ring_hop_bwd_.launches == n


@pytest.mark.parametrize("plan,t_local", [
    ("contiguous", 256), ("non_causal", 256), ("zigzag", 256), ("zigzag", 1024),
])
def test_ring_hop_forward_on_stressed_inputs(cuda_device, plan, t_local):
    """B3, on the tensor cores in 3xTF32, for every hop and panel of a
    4-rank ring with q scaled by 8 (large scores, a nearly one-hot
    softmax), against the plain hops on the same card tensors, TF32 off,
    at ``FWD_TOL``; a skipped rank writes (0, -1e30) exactly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    layout, causal = RING_PLANS[plan]
    sp, b, h, kv, d = 4, 1, 4, 2, 128
    gen = torch.Generator().manual_seed(t_local + 8)
    q = torch.randn(b, sp * t_local, h, d, generator=gen).to(cuda_device) * 8.0
    k, v = (torch.randn(b, sp * t_local, kv, d, generator=gen).to(cuda_device) for _ in range(2))
    stripes, panels = flash_ring.hop_plan(layout, t_local, causal)
    flash_ring.reset_launch_counts()
    n = 0
    for hop in range(sp):
        for stripe, k_off, rule in panels:
            q_off, rows = stripes[stripe]
            kw = dict(sp=sp, hop=hop, cases=flash_ring.hop_cases(sp, hop, rule), rows=rows,
                      q_off=q_off, k_off=k_off)
            o, l = flash_ring.ring_hop_fwd(q, k, v, **kw)
            want_o, want_l = flash_ring.torch_ring_hop_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            skipped = want_l == flash_ring.NEG_INF
            assert torch.equal(l[skipped], want_l[skipped])
            assert max_rel_err(o, want_o) <= FWD_TOL
            assert max_rel_err(l[~skipped], want_l[~skipped]) <= FWD_TOL
            n += 1
    assert flash_ring.ring_hop_fwd.launches == n


@pytest.mark.parametrize("plan,t_local,q_scale", [
    ("contiguous", 256, 8.0), ("zigzag", 256, 8.0), ("contiguous", 2048, 1.0),
])
def test_ring_hop_backward_on_stressed_inputs(cuda_device, plan, t_local, q_scale):
    """B4, on the tensor cores in 3xTF32, for every hop and panel of a
    4-rank ring with q scaled by 8 (large scores, a nearly one-hot
    softmax), and at the long-context path's T_local 2048: added into
    non-zero accumulators, against the plain hops on the same card
    tensors, TF32 off, at the same normwise ``BWD_TOL``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    layout, causal = RING_PLANS[plan]
    sp, b, h, kv, d = 4, 1, 4, 2, 128
    gen = torch.Generator().manual_seed(t_local + int(q_scale))
    q, do = (torch.randn(b, sp * t_local, h, d, generator=gen).to(cuda_device) for _ in range(2))
    q = q * q_scale
    k, v = (torch.randn(b, sp * t_local, kv, d, generator=gen).to(cuda_device) for _ in range(2))
    out32, lse = flash_ring.ring_forward(q, k, v, sp, layout, causal, impl="jnp")
    di = (out32 * do).sum(-1).transpose(1, 2).contiguous()
    stripes, panels = flash_ring.hop_plan(layout, t_local, causal)
    flash_ring.reset_launch_counts()
    n = 0
    for hop in range(sp):
        for stripe, k_off, rule in panels:
            q_off, rows = stripes[stripe]
            kw = dict(sp=sp, hop=hop, cases=flash_ring.hop_cases(sp, hop, rule), rows=rows,
                      q_off=q_off, k_off=k_off)
            start = [torch.randn(x.shape, generator=gen).to(cuda_device) for x in (q, k, v)]
            got, want = [x.clone() for x in start], [x.clone() for x in start]
            flash_ring.ring_hop_bwd_(q, k, v, lse, do, di, *got, **kw)
            flash_ring.torch_ring_hop_bwd_(q, k, v, lse, do, di, *want, **kw)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert max_rel_err(g, w) <= BWD_TOL
            n += 1
    assert flash_ring.ring_hop_bwd_.launches == n


def test_ring_hop_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 512, 4, 128, device=cuda_device)
    k = torch.zeros(1, 512, 2, 128, device=cuda_device)
    cases = flash_ring.hop_cases(4, 0, "causal")
    with pytest.raises(TypeError):
        flash_ring.ring_hop_fwd(q.double(), k, k, sp=4, hop=0, cases=cases)
    with pytest.raises(ValueError):
        flash_ring.ring_hop_fwd(q, k.cpu(), k, sp=4, hop=0, cases=cases)
    with pytest.raises(ValueError, match="multiple of 128"):
        flash_ring.ring_hop_fwd(q, k, k, sp=4, hop=0, cases=cases, rows=64)
    with pytest.raises(ValueError, match="head dim"):
        flash_ring.ring_hop_fwd(q[..., :64], k[..., :64], k[..., :64], sp=4, hop=0, cases=cases)
    with pytest.raises(ValueError, match="sp = 64"):
        flash_ring.ring_hop_fwd(q, k, k, sp=64, hop=0, cases=(flash_ring.FULL,) * 64)
    lse = torch.zeros(1, 4, 512, device=cuda_device)
    dq, dk = torch.zeros_like(q), torch.zeros_like(k)
    with pytest.raises(ValueError, match="contiguous"):
        flash_ring.ring_hop_bwd_(q, k, k, lse, q, lse, dq.transpose(1, 2).contiguous()
                                 .transpose(1, 2), dk, dk.clone(), sp=4, hop=0, cases=cases)
    with pytest.raises(ValueError, match="lse"):
        flash_ring.ring_hop_bwd_(q, k, k, lse[:, :, :256], q, lse, dq, dk, dk.clone(),
                                 sp=4, hop=0, cases=cases)


SP_KW = dict(
    vocab_size=512, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
    d_ff=384, max_seq_len=512, lora_rank=4,
)


@pytest.mark.parametrize("layout,strategy", [("contiguous", "ring"), ("zigzag", "ring"),
                                             ("contiguous", "a2a")])
def test_sp_lora_step_on_card_matches_cpu(cuda_device, layout, strategy):
    """Two steps of a 2-peer sequence-parallel LoRA fine-tune at head_dim
    128, T 512 over 2 virtual ranks (zigzag half stripes of 128): on the
    card (the ring's hops through B3/B4, Ulysses through B5, the exchange
    through B1) and on the CPU (the plain versions), from the same
    parameters and batches, TF32 off.  Tolerances as the Llama step's
    above; the frozen leaves bit-identical."""
    from dpwa_tpu_torch.ops.zigzag_ring import zigzag_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    n, steps, sp = 2, 2, 2
    cfg_kw = dict(SP_KW, sp_axis="sp", sp_layout=layout, sp_strategy=strategy)
    model = llama.Llama(llama.LlamaConfig(**cfg_kw))
    init = llama.init(model, prng.key(0))
    gen = torch.Generator().manual_seed(1)
    params = {
        k: torch.stack([v, v + 0.01 * torch.randn(v.shape, generator=gen)])
        for k, v in init.items()
    }
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(steps):
        toks = torch.from_numpy(rng.integers(0, SP_KW["vocab_size"], (n, 1, 513)))
        x, y = toks[..., :-1], toks[..., 1:]
        if layout == "zigzag":
            x, y = zigzag_shard(x, sp, axis=2), zigzag_shard(y, sp, axis=2)
        batches.append((x, y))
    results = []
    for device in ("cpu", cuda_device):
        t = stacked.StackedTransport(make_local_config(n, schedule="ring"), device=device)
        opt = lora_optimizer(adam(1e-3), llama.lora_filter)

        def loss_fn(p, batch):
            logits = llama.apply(model, p, batch[0])
            losses = softmax_cross_entropy_with_integer_labels(logits, batch[1])
            return losses.sum(), torch.tensor(float(losses.numel()), device=losses.device)

        state = train_sp.init_gossip_sp_state(params, opt, t)
        step = train_sp.make_gossip_sp_train_step(
            loss_fn, opt, t, exchange_filter=llama.lora_filter, sp=sp
        )
        merge.reset_launch_counts()
        flash_attention.reset_launch_counts()
        flash_ring.reset_launch_counts()
        losses = []
        for x, y in batches:
            state, loss, _ = step(state, (x.to(device), y.to(device)))
            losses.append(loss.cpu())
        launches = (
            flash_ring.ring_hop_fwd.launches, flash_ring.ring_hop_bwd_.launches,
            flash_attention.flash_attn_fwd.launches, merge.pair_merge_.launches,
        )
        views = {k: v.cpu() for k, v in state.params.views().items()}
        results.append((torch.stack(losses), views, launches))
    (cpu_l, cpu_p, cpu_n), (gpu_l, gpu_p, gpu_n) = results
    layers = SP_KW["n_layers"]
    hops = layers * sp * (3 if layout == "zigzag" else 1) * steps
    assert cpu_n == (0, 0, 0, 0)
    if strategy == "ring":
        assert gpu_n == (hops, hops, 0, steps)
    else:
        assert gpu_n == (0, 0, layers * steps, steps)
    torch.testing.assert_close(gpu_l, cpu_l, rtol=1e-4, atol=1e-6)
    for name, want in cpu_p.items():
        got = gpu_p[name]
        if llama.lora_filter(name):
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
            loose = (got - want).abs() > 1e-5 + 1e-3 * want.abs()
            assert loose.float().mean().item() < 0.01
        else:
            assert torch.equal(got, params[name]) and torch.equal(want, params[name])


def _card_rows(cpu: torch.Tensor, device, lead: int, pad: int) -> torch.Tensor:
    """``cpu`` on the card as a column slice starting ``lead`` floats into
    rows ``pad`` floats wider than needed (lead 3: rows off the 16-byte
    boundary)."""
    n, d = cpu.shape
    buf = torch.zeros(n, lead + d + pad, device=device)
    view = buf[:, lead:lead + d]
    view.copy_(cpu)
    return view


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("layout", ["aligned", "ragged", "misaligned", "phase"])
def test_wire_forms_bit_equal_to_plain(cuda_device, layout, wire):
    """B1 and B2 reading the partner's row from a second buffer w (the int8
    wire's dequantized rows), against their plain versions, bit for bit:
    rows aligned, ragged (d not a multiple of 4), starting off the 16-byte
    boundary in both buffers, and in buffers whose rows start at different
    offsets within 16 bytes (the scalar form).  Sat-out rows hold inf, -inf
    and NaN in x and in w, and come out NaN there."""
    d = {"aligned": 4096, "ragged": 4099, "misaligned": 4099, "phase": 4096}[layout]
    x_lead = 3 if layout in ("misaligned", "phase") else 0
    w_lead = 3 if layout == "misaligned" else 0
    gen = torch.Generator().manual_seed(d + len(wire))
    base = torch.randn(N, d, generator=gen)
    w_cpu = base + 0.25 * torch.randn(N, d, generator=gen)
    alpha = torch.rand(N, generator=gen)
    fixed = np.flatnonzero(WITH_FIXED == np.arange(N))
    alpha[fixed] = 0.0
    bad = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0, 3.0e38])
    for t in (base, w_cpu):
        t[fixed, :5] = bad
        t[fixed, -5:] = bad
    w = _card_rows(w_cpu, cuda_device, w_lead, 29)
    merge.reset_launch_counts()
    left, right = (torch.from_numpy(v) for v in merge.involution_pairs(WITH_FIXED, self_pairs=True))
    x = _card_rows(base, cuda_device, x_lead, 29)
    merge.pair_merge_(x, left.to(cuda_device), right.to(cuda_device), alpha.to(cuda_device),
                      wire=wire, self_pairs=True, w=w)
    want = merge.torch_pair_merge_(base.clone(), left, right, alpha, wire=wire,
                                   self_pairs=True, w=w_cpu)
    got = x.cpu()
    both_nan = got.isnan() & want.isnan()
    assert bool(((got.view(torch.int32) == want.view(torch.int32)) | both_nan).all())
    assert bool(got[fixed][:, :3].isnan().all())
    partner = torch.from_numpy(RING_ODD.astype(np.int32))
    got = merge.gather_merge(_card_rows(base, cuda_device, x_lead, 29), partner.to(cuda_device),
                             alpha.to(cuda_device), wire=wire, w=w).cpu()
    want = merge.torch_pairwise_merge(base, partner, alpha, wire=wire, w=w_cpu)
    both_nan = got.isnan() & want.isnan()
    assert bool(((got.view(torch.int32) == want.view(torch.int32)) | both_nan).all())
    assert merge.pair_merge_.launches == 1 and merge.gather_merge.launches == 1


def test_wire_form_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device)
    idx = torch.tensor([0, 2], dtype=torch.int32, device=cuda_device)
    alpha = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError, match="pass w"):
        merge.pair_merge_(x, idx, idx + 1, alpha, wire="int8")
    with pytest.raises(ValueError, match="storage"):
        merge.pair_merge_(x, idx, idx + 1, alpha, wire="int8", w=x[:, :8])
    with pytest.raises(ValueError, match="shape"):
        merge.gather_merge(x, torch.arange(4, dtype=torch.int32, device=cuda_device), alpha,
                           wire="int8", w=torch.zeros(4, 7, device=cuda_device))
    with pytest.raises(ValueError, match="unknown wire"):
        merge.pair_merge_(x, idx, idx + 1, alpha, wire="int4", w=torch.zeros_like(x))


def test_fake_quant_rows_on_card_bit_equal_to_cpu(cuda_device):
    """The int8 wire's quantisation on the card (threefry in int64, IEEE
    division, floor) gives the CPU's bits, inf and NaN chunks included."""
    from dpwa_tpu_torch.ops.quantize import WirePlan, fake_quant_rows

    gen = torch.Generator().manual_seed(9)
    x = torch.randn(4, 5000, generator=gen)
    x[1, 10], x[2, 300] = float("inf"), float("nan")
    leaves = [(0, 300), (300, 301), (301, 4999)]
    w_cpu = fake_quant_rows(x, torch.zeros_like(x), WirePlan(leaves, "cpu"), 3, 7)
    w = fake_quant_rows(x.to(cuda_device), torch.zeros(4, 5000, device=cuda_device),
                        WirePlan(leaves, cuda_device), 3, 7, max_elements=1024).cpu()
    both_nan = w.isnan() & w_cpu.isnan()
    assert bool(((w.view(torch.int32) == w_cpu.view(torch.int32)) | both_nan).all())


def test_int8_draws_step_on_card_matches_cpu(cuda_device):
    """Three steps of a 4-peer ResNet-8 with partial participation and
    faults on the int8 wire, on the card (B1's wire form, the mask copied
    from the host) and on the CPU: the same participation, losses rtol
    1e-4, and parameters rtol 1e-3 / atol 1e-4 as the f32 step test except
    where the stochastic rounding flipped: cuDNN and the CPU sum in other
    orders, and a weight that differs in its last bits can round to the
    next int8 code, one step of max|chunk|/127 times α.  So at most 0.1 %
    of the parameters (4 of 312,168 in one card run) may differ by more,
    and none by more than max|parameter|/127."""
    torch.backends.cudnn.allow_tf32 = False
    n, steps = 4, 3
    rng = np.random.default_rng(1)
    batches = [
        (torch.from_numpy(rng.random((n, 8, 32, 32, 3), np.float32)),
         torch.from_numpy(rng.integers(0, 10, (n, 8)).astype(np.int32)))
        for _ in range(steps)
    ]
    results = []
    for device in ("cpu", cuda_device):
        model = resnet.CifarResNet(depth=8).to(device)
        cfg = make_local_config(n, schedule="random", pool_size=4, interpolation="loss",
                                factor=0.9, wire_dtype="int8", fetch_probability=0.5,
                                drop_probability=0.1)
        t = stacked.StackedTransport(cfg, device=device)
        opt = sgd(0.1, momentum=0.9)

        def loss_fn(params, batch):
            logits = torch.func.functional_call(model, params, (batch[0],))
            return softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean()

        state = stacked.init_stacked_state(
            init_params_per_peer(lambda k: resnet.init(model, k), prng.key(0), n, device), opt, t
        )
        step = stacked.make_stacked_train_step(loss_fn, opt, t)
        merge.reset_launch_counts()
        losses, masks = [], []
        for x, y in batches:
            state, loss, info = step(state, (x.to(device), y.to(device)))
            losses.append(loss.cpu())
            masks.append(info.participated.cpu())
        results.append((torch.stack(losses), state.params.flat.cpu(), torch.stack(masks),
                        merge.pair_merge_.launches))
    (cpu_l, cpu_p, cpu_m, cpu_n), (gpu_l, gpu_p, gpu_m, gpu_n) = results
    assert cpu_n == 0 and gpu_n == steps and torch.equal(cpu_m, gpu_m)
    torch.testing.assert_close(gpu_l, cpu_l, rtol=1e-4, atol=1e-6)
    diff = (gpu_p - cpu_p).abs()
    flipped = diff > 1e-4 + 1e-3 * cpu_p.abs()
    assert flipped.float().mean().item() <= 1e-3
    assert diff.max().item() <= cpu_p.abs().max().item() / 127


def test_resnet50_forward_on_card_matches_cpu(cuda_device):
    """ResNet-50 at 64×64, batch 2, on the card against the CPU port, TF32
    off: logits rtol 1e-4 / atol 1e-4 (cuDNN's and the CPU's sums)."""
    torch.backends.cudnn.allow_tf32 = False
    model = resnet.ResNet50()
    x = torch.from_numpy(np.random.default_rng(3).random((2, 64, 64, 3), np.float32))
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda_device)(x.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


BERT_NARROW = bert.BertConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, d_ff=256,
                              max_seq_len=32)


def test_bert_hierarchical_step_on_card_matches_cpu(cuda_device):
    """Four steps of 8 narrow BERTs in 2 groups of 4 on the hierarchical
    schedule (three intra-group slots, then the inter-group one), AdamW at
    lr 1e-3, from one init stacked on every peer: on the card (the exchange
    through B1) and on the CPU (the plain merge), from the same batches,
    TF32 off.  Losses within rtol 1e-4 and the pairings equal; parameters
    within rtol 1e-3 / atol 1e-5 on 99 % of their elements and atol 4·lr
    on all (Adam takes steps of size lr whatever the gradient's size, so a
    gradient that nearly cancels moves its element by lr times its
    relative error; the attention's key biases, whose gradient is 0 in
    exact arithmetic, are all such elements and are left out of the 99 %)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, group, steps, lr, t = 8, 4, 4, 1e-3, 32
    model = bert.BertMLM(BERT_NARROW)
    init = bert.init(model, prng.key(0))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(steps):
        seq = [rng.integers(1, BERT_NARROW.vocab_size, (n, 2, 1))]
        for _ in range(t - 1):
            seq.append((2 * seq[-1] + 1) % BERT_NARROW.vocab_size)
        batches.append(bert.mlm_mask_batch(np.concatenate(seq, axis=-1), rng))
    results = []
    for device in ("cpu", cuda_device):
        cfg = make_local_config(n, schedule="hierarchical", group_size=group, inter_period=4)
        t_ = stacked.StackedTransport(cfg, device=device)
        opt = adamw(lr)
        state = stacked.init_stacked_state(stack_params(init, n, device), opt, t_)
        step = stacked.make_stacked_train_step(bert.mlm_loss_fn(model), opt, t_)
        merge.reset_launch_counts()
        losses, partners = [], []
        for batch in batches:
            state, loss, info = step(state, tuple(torch.from_numpy(a).to(device) for a in batch))
            losses.append(loss.cpu())
            partners.append(info.partner.cpu())
        views = {k: v.cpu() for k, v in state.params.views().items()}
        results.append((torch.stack(losses), torch.stack(partners), views,
                        merge.pair_merge_.launches))
    (cpu_l, cpu_p, cpu_v, cpu_n), (gpu_l, gpu_p, gpu_v, gpu_n) = results
    assert cpu_n == 0 and gpu_n == steps
    assert torch.equal(gpu_p, cpu_p)
    groups = torch.arange(n) // group
    assert bool((groups[cpu_p[3].long()] != groups).all())
    torch.testing.assert_close(gpu_l, cpu_l, rtol=1e-4, atol=1e-6)
    for name, want in cpu_v.items():
        got = gpu_v[name]
        torch.testing.assert_close(got, want, rtol=0, atol=4 * lr)
        if not name.endswith("attn.key.bias"):
            loose = (got - want).abs() > 1e-5 + 1e-3 * want.abs()
            assert loose.float().mean().item() < 0.01, name


@pytest.mark.parametrize("which,hw", [("SmallNet", 8), ("ConvNet", 28)])
def test_mnist_models_on_card_match_cpu(cuda_device, which, hw):
    """SmallNet and ConvNet (each from prng.key(0)) on the card against the
    CPU port, batch 16, TF32 off: logits rtol 1e-4 / atol 1e-5."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = getattr(mnist, which)()
    x = torch.from_numpy(np.random.default_rng(hw).random((16, hw, hw, 1), np.float32))
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda_device)(x.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _batchnorm_steps(device, overlap, steps=3, n=4, nudge=0.0):
    """``steps`` with_state steps of 4 ResNet-8 (BatchNorm) peers on
    ``device``, each peer's inputs offset by its index (``nudge``: each
    input scaled by ``1 + nudge·N(0, 1)``): the losses, the parameters, the
    statistics and the pair-merge launches."""
    rng, noise = np.random.default_rng(0), np.random.default_rng(1)
    shifts = np.arange(n, dtype=np.float32)[:, None, None, None, None]
    batches = []
    for _ in range(steps):
        x = rng.random((n, 8, 16, 16, 3), np.float32) + shifts
        x = (x * (1 + nudge * noise.standard_normal(x.shape))).astype(np.float32)
        batches.append((torch.from_numpy(x), torch.from_numpy(rng.integers(0, 10, (n, 8)).astype(np.int32))))
    model = resnet.CifarResNet(depth=8, norm_type="batch").to(device)
    t = stacked.StackedTransport(
        make_local_config(n, interpolation="loss", factor=0.9), device=device)
    opt = sgd(0.05, momentum=0.9)

    def loss_fn(params, model_state, batch):
        logits, new = resnet.apply_batch_norm(model, params, model_state, batch[0])
        return softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean(), new

    params = init_params_per_peer(lambda k: resnet.init(model, k), prng.key(0), n, device)
    stats = {k: v.expand(n, *v.shape).clone() for k, v in resnet.batch_stats(model, device).items()}
    state = stacked.init_stacked_state(params, opt, t, stats)
    step = stacked.make_stacked_train_step(loss_fn, opt, t, with_state=True, overlap=overlap)
    merge.reset_launch_counts()
    losses = []
    for x, y in batches:
        state, loss, _ = step(state, (x.to(device), y.to(device)))
        losses.append(loss.cpu())
    return (torch.stack(losses), state.params.flat.cpu(), state.model_state.flat.cpu(),
            merge.pair_merge_.launches)


@pytest.mark.parametrize("overlap", [False, True])
def test_batchnorm_stacked_step_on_card_matches_cpu(cuda_device, overlap):
    """Three with_state steps of 4 ResNet-8 peers with BatchNorm on the card
    (the parameters and the statistics merged by ONE pair-merge launch a
    step) and on the CPU (the plain merge), TF32 off: losses rtol 1e-4 /
    atol 1e-6, parameters rtol 1e-3 / atol 1e-4, statistics rtol 1e-4 /
    atol 1e-5, each atol raised to 4× the CPU run's own change when its
    inputs are nudged by 1e-7 relative (float32 rounding).  On the CPU that
    nudge moves the parameters by up to 3.5e-5 without overlap and 4.7e-4
    with it (the losses by 5e-7 and 1.3e-4): the overlapped run of these
    peer-offset inputs is ill-conditioned, and a fixed atol would test the
    rounding, not the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = _batchnorm_steps("cpu", overlap)
    nudged = _batchnorm_steps("cpu", overlap, nudge=1e-7)
    gpu = _batchnorm_steps(cuda_device, overlap)
    assert cpu[3] == 0 and gpu[3] == 3
    for i, (rtol, atol) in enumerate(((1e-4, 1e-6), (1e-3, 1e-4), (1e-4, 1e-5))):
        spread = float((nudged[i] - cpu[i]).abs().max())
        torch.testing.assert_close(gpu[i], cpu[i], rtol=rtol, atol=max(atol, 4 * spread))


def test_checkpoint_round_trip_of_a_card_state(cuda_device, tmp_path):
    """A card state with Adam and model state, saved and restored into a
    fresh card state's buffers (in place, the shared buffer kept): bit for
    bit, and the next step from each is the same."""
    torch.backends.cudnn.allow_tf32 = False
    n = 2
    model = mnist.SmallNet().to(cuda_device)
    t = stacked.StackedTransport(make_local_config(n), device=cuda_device)
    opt = adam(2e-3)

    def loss_fn(params, model_state, batch):
        logits = torch.func.functional_call(model, params, (batch[0],))
        new = {"m": 0.9 * model_state["m"] + 0.1 * logits.mean(0)}
        return softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean(), new

    init = lambda seed: stacked.init_stacked_state(
        init_params_per_peer(lambda k: mnist.init(model, k), prng.key(seed), n, cuda_device),
        opt, t, {"m": torch.zeros(n, 10, device=cuda_device)})
    step = stacked.make_stacked_train_step(loss_fn, opt, t, with_state=True)
    rng = np.random.default_rng(1)
    batch = lambda: (torch.from_numpy(rng.random((n, 32, 8, 8, 1), np.float32)).to(cuda_device),
                     torch.from_numpy(rng.integers(0, 10, (n, 32)).astype(np.int32)).to(cuda_device))
    state = init(0)
    for _ in range(3):
        state, _, _ = step(state, batch())
    torch.cuda.synchronize()
    ckpt = str(tmp_path / "ck")
    checkpoint.save_checkpoint(ckpt, state)
    like = init(5)
    buffer = like.params.buffer
    restored = checkpoint.restore_checkpoint(ckpt, like=like)
    assert restored is like and restored.params.buffer is buffer
    assert restored.params.buffer.device.type == "cuda" and restored.step == 3
    for a, b in ((restored.params.flat, state.params.flat), (restored.model_state.flat, state.model_state.flat),
                 (restored.opt_state.mu, state.opt_state.mu), (restored.opt_state.nu, state.opt_state.nu),
                 (restored.clock, state.clock), (restored.loss, state.loss)):
        assert a.device.type == "cuda" and torch.equal(a, b)
    assert restored.opt_state.count == state.opt_state.count == 3
    last = batch()
    merge.reset_launch_counts()
    s1, _, _ = step(state, last)
    s2, _, _ = step(restored, last)
    assert merge.pair_merge_.launches == 2
    torch.testing.assert_close(s2.params.flat, s1.params.flat, rtol=0, atol=0)
    torch.testing.assert_close(s2.model_state.flat, s1.model_state.flat, rtol=0, atol=0)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["aligned", "ragged", "misaligned", "phase"])
def test_b2_single_row_tcp_merge_bit_equal_to_plain(cuda_device, layout, wire):
    """B2 over one row ``[1, d]`` as the TCP transport's merge engine runs
    it: the landed frame as w, float32 (the int8 wire's form,
    ``fma(1-α, x, α·y)``) or bf16 read as it landed (the bf16 form, widened
    in the kernel), against the plain version on a CPU copy, bit for bit:
    rows aligned, ragged, both starting off their boundaries, and at
    different phases (the scalar form).  The row holds inf, -inf and NaN."""
    from dpwa_tpu_torch.device.engine import BF16_FORM, F32_FORM

    d = {"aligned": 1 << 20, "ragged": (1 << 20) + 3, "misaligned": (1 << 20) + 1,
         "phase": 1 << 20}[layout]
    x_lead = 3 if layout in ("misaligned", "phase") else 0
    w_lead = 3 if layout == "misaligned" else 0
    gen = torch.Generator().manual_seed(d)
    x_cpu = torch.randn(1, d, generator=gen)
    w_cpu = torch.randn(1, d, generator=gen)
    x_cpu[0, :3] = w_cpu[0, -3:] = torch.tensor([float("inf"), float("-inf"), float("nan")])
    dtype = torch.bfloat16 if wire == "bf16" else torch.float32
    w_cpu = w_cpu.to(dtype)
    x = torch.zeros(1, x_lead + d, device=cuda_device)[:, x_lead:]
    x.copy_(x_cpu)
    w = torch.zeros(1, w_lead + d, dtype=dtype, device=cuda_device)[:, w_lead:]
    w.copy_(w_cpu)
    form = BF16_FORM if wire == "bf16" else F32_FORM
    alpha, zero = torch.tensor([0.3]), torch.zeros(1, dtype=torch.int32)
    merge.reset_launch_counts()
    got = merge.gather_merge(x, zero.to(cuda_device), alpha.to(cuda_device), wire=form, w=w).cpu()
    want = merge.torch_pairwise_merge(x_cpu, zero, alpha, wire=form, w=w_cpu)
    both_nan = got.isnan() & want.isnan()
    assert bool(((got.view(torch.int32) == want.view(torch.int32)) | both_nan).all())
    assert merge.gather_merge.launches == 1
    with pytest.raises(TypeError):
        merge.pair_merge_(x, zero.to(cuda_device), zero.to(cuda_device),
                          alpha.to(cuda_device), wire="bf16", w=w.to(torch.bfloat16))


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_exchange_on_device_pair_on_card_equals_cpu_pair(cuda_device, wire):
    """Two in-process TCP nodes with device-resident replicas, run
    lock-step 3 rounds at α ≠ 0.5, end bit-equal to the same pair on the
    CPU; one B2 launch a merged round, the frames landing from pinned
    memory."""
    import dataclasses

    from dpwa_tpu_torch.device import handoff
    from dpwa_tpu_torch.parallel.tcp import TcpTransport

    cfg = make_local_config(2, interpolation="clock", factor=0.7, wire_dtype=wire)
    cfg = dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))
    gen = torch.Generator().manual_seed(5)
    start = [torch.randn(300_001, generator=gen) for _ in range(2)]
    finals = {}
    for device in ("cpu", cuda_device):
        nodes = [TcpTransport(cfg, f"node{i}", device=device) for i in range(2)]
        try:
            for t in nodes:
                for i, other in enumerate(nodes):
                    t.set_peer_port(i, other.port)
            vecs = [v.to(device) for v in start]
            merge.reset_launch_counts()
            handoff.reset_handoff_stats()
            for r in range(3):
                clocks = [r + 1.0, r + 3.0]
                for t, v, c in zip(nodes, vecs, clocks):
                    t.publish(v, c, 0.5)
                vecs = [t.exchange_on_device(v, c, 0.5, r)[0] for t, v, c in zip(nodes, vecs, clocks)]
            if device != "cpu":
                assert merge.gather_merge.launches == 6
                assert handoff.handoff_stats()["h2d_pinned"] == 6
            finals[str(device)] = [v.cpu() for v in vecs]
        finally:
            for t in nodes:
                t.close()
    for got, want in zip(finals[str(cuda_device)], finals["cpu"]):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_rollback_ring_on_card(cuda_device):
    """The ring's snapshots live on the card, in buffers made once at the
    first push; a rollback hands back the newest, then digs deeper."""
    from dpwa_tpu_torch.recovery import RollbackRing

    ring = RollbackRing(3)
    gen = torch.Generator().manual_seed(8)
    cpu = [torch.randn(1_000_003, generator=gen) for _ in range(5)]
    slots = set()
    for i, v in enumerate(cpu):
        dev = v.to(cuda_device, copy=True)
        ring.push(dev, i, float(i), 0.1 * i)
        dev.fill_(float("nan"))  # the replica moves on: the ring holds copies
        slots.add(ring._slots.data_ptr())
    assert len(slots) == 1 and ring._slots.is_cuda
    for want in (4, 3, 2):
        snap = ring.rollback()
        assert snap.vec.is_cuda and snap.step == want
        assert torch.equal(snap.vec.cpu(), cpu[want])
    assert ring.rollback() is None


def test_bootstrap_and_rollback_on_card(cuda_device):
    """Two port nodes with their replicas on the card: the rejoiner's
    bootstrap lands the donor's lazily packed state on the card (bit for
    bit, with its step and clock), and a NaN step rolls back to the card's
    ring, the frame carrying the snapshot's loss."""
    import dataclasses

    from dpwa_tpu_torch.adapters import DpwaTcpAdapter
    from dpwa_tpu_torch.parallel import protocol_constants as pc
    from dpwa_tpu_torch.parallel.tcp import TcpTransport

    cfg = make_local_config(2, factor=0.3, disabled_planes=("membership", "trust", "flowctl"))
    cfg = dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))
    gen = torch.Generator().manual_seed(9)
    tree = {"w": torch.randn(300, 201, generator=gen), "b": torch.randn(201, generator=gen)}
    donor = DpwaTcpAdapter(tree, "node0", cfg, device=cuda_device)
    rejoiner = None
    try:
        for r in range(3):
            donor.update(0.5 + r)
        t = TcpTransport(cfg, "node1", device=cuda_device)
        t.set_peer_port(0, donor.transport.port)
        rejoiner = DpwaTcpAdapter({k: torch.zeros_like(v) for k, v in tree.items()}, "node1",
                                  cfg, transport=t, bootstrap=True)
        assert rejoiner.flat.flat.is_cuda and rejoiner.last_bootstrap["donor"] == 0
        assert (rejoiner.step, rejoiner.clock) == (donor.step, donor.clock) == (3, 3.0)
        assert torch.equal(rejoiner.vector().cpu().view(torch.int32),
                           donor.vector().cpu().view(torch.int32))
        donor.transport.set_peer_port(1, rejoiner.transport.port)
        rejoiner.update(1.0)
        good = rejoiner.vector().cpu()
        rejoiner.flat.flat.fill_(float("nan"))
        rejoiner.update(float("nan"))
        assert rejoiner.last_rollback["restored"] and rejoiner.last_rollback["snapshot_step"] == 3
        assert rejoiner.ring._slots.is_cuda and torch.isfinite(rejoiner.vector()).all()
        assert torch.isfinite(good).all()
        frame_loss = pc.BLOB_HDR.unpack_from(rejoiner.transport.server._payload, 0)[4]
        assert frame_loss == 1.0  # the snapshot's loss, not the NaN
    finally:
        donor.close()
        if rejoiner is not None:
            rejoiner.close()
