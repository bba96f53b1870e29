"""The port's single-device attention against the reference's.

``dpwa_tpu_torch.ops.ulysses.single_device_attention`` — its dense branch,
and its flash branch (B5's autograd path, which on CPU tensors runs the
kernels' plain versions) — against ``dpwa_tpu.ops.ulysses.
single_device_attention(impl="dense")`` on float32 inputs made with numpy:
outputs at rtol 1e-5 / atol 1e-6, and the gradients of a scalar loss with
respect to q, k and v against ``jax.grad`` at rtol 1e-4 / atol 1e-6.

The flash branch's backward takes ``Δ = rowsum(dO∘O)``, as the kernels do,
where autodiff takes ``rowsum(P∘dP)``: equal in exact arithmetic, a few
ulps of the O(√D)-sized ``dP`` apart in float32.  A gradient that cancels
to zero (the first query row of a causal mask has one key, so its dQ is 0)
then comes out at a few 1e-6 instead (dP is about 11 here, so its ulps
are about 1e-6, summed over the keys): the flash branch's gradients are
held at rtol 1e-4 / atol 1e-5.  The CUDA kernels themselves run on the card
(``tests/test_torch_card.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpwa_tpu.ops.ulysses import single_device_attention as ref_attention
from dpwa_tpu_torch.ops import flash_attention
from dpwa_tpu_torch.ops.ulysses import single_device_attention

B, H, D = 2, 4, 128


def _inputs(t, kv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, t, H, D)).astype(np.float32)
    k = rng.standard_normal((B, t, kv, D)).astype(np.float32)
    v = rng.standard_normal((B, t, kv, D)).astype(np.float32)
    w = rng.standard_normal((B, t, H, D)).astype(np.float32)
    return q, k, v, w


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [4, 2, 1])
@pytest.mark.parametrize("t", [128, 256])
def test_attention_and_gradients_match_reference(t, kv, causal, impl):
    q, k, v, w = _inputs(t, kv)

    def ref_loss(q, k, v):
        return jnp.sum(ref_attention(q, k, v, causal=causal, impl="dense") * w)

    want = np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, impl="dense"))
    want_grads = jax.grad(ref_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    flash_attention.reset_launch_counts()
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = single_device_attention(tq, tk, tv, causal=causal, impl=impl)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    (out * torch.from_numpy(w)).sum().backward()
    atol = 1e-6 if impl == "dense" else 1e-5
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=atol)
    # CPU tensors take the plain versions: no kernel launch.
    assert flash_attention.flash_attn_fwd.launches == 0
    assert flash_attention.flash_attn_bwd.launches == 0


def test_vmapped_grad_makes_one_call_per_pass(monkeypatch):
    """Under ``vmap(grad(...))`` over 3 peers the flash branch makes ONE
    forward and ONE backward call with the peer axis folded into the
    batch, and gives the dense branch's gradients."""
    n, t, kv = 3, 128, 2
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, B, t, h, D)).astype(np.float32))
               for h in (H, kv, kv))
    w = torch.from_numpy(rng.standard_normal((B, t, H, D)).astype(np.float32))
    calls = []
    fwd, bwd = flash_attention.torch_flash_attn_fwd, flash_attention.torch_flash_attn_bwd

    def spy_fwd(q, k, v, *, causal):
        calls.append(("fwd", tuple(q.shape), tuple(k.shape)))
        return fwd(q, k, v, causal=causal)

    def spy_bwd(q, k, v, o, lse, do, *, causal):
        calls.append(("bwd", tuple(q.shape), tuple(k.shape)))
        return bwd(q, k, v, o, lse, do, causal=causal)

    monkeypatch.setattr(flash_attention, "torch_flash_attn_fwd", spy_fwd)
    monkeypatch.setattr(flash_attention, "torch_flash_attn_bwd", spy_bwd)

    def loss(q, k, v, impl):
        return (single_device_attention(q, k, v, causal=True, impl=impl) * w).sum()

    grads = {
        impl: torch.func.vmap(
            torch.func.grad(loss, argnums=(0, 1, 2)), in_dims=(0, 0, 0, None)
        )(q, k, v, impl)
        for impl in ("flash", "dense")
    }
    assert calls == [
        ("fwd", (n * B, t, H, D), (n * B, t, kv, D)),
        ("bwd", (n * B, t, H, D), (n * B, t, kv, D)),
    ]
    for a, b in zip(grads["flash"], grads["dense"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_auto_takes_the_dense_branch_on_the_cpu(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the flash branch ran on CPU tensors under auto")

    monkeypatch.setattr(flash_attention, "torch_flash_attn_fwd", refuse)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(128, 2))
    out = single_device_attention(q, k, v, causal=True, impl="auto")
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="impl"):
        single_device_attention(q, k, v, causal=True, impl="xla")


def test_plain_lse_is_the_rows_logsumexp():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(128, 1, seed=2))
    o, lse = flash_attention.torch_flash_attn_fwd(q, k, v, causal=True)
    ke = k.repeat_interleave(H, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, ke) / D ** 0.5
    s = s.masked_fill(~torch.ones(128, 128, dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6, atol=1e-6)
    assert lse.shape == (B, H, 128) and o.shape == q.shape


@pytest.mark.parametrize(
    "shapes, match",
    [
        (((1, 128, 4, 96), (1, 128, 4, 96)), "head dim"),
        (((1, 128, 4, 64), (1, 128, 4, 64)), "head dim"),
        (((1, 192, 4, 128), (1, 192, 4, 128)), "multiple of 128"),
        (((1, 128, 4, 128), (1, 128, 3, 128)), "kv heads"),
        (((1, 128, 4, 128), (1, 256, 4, 128)), "k and v"),
    ],
)
def test_kernel_shape_checks(shapes, match):
    """What the wrappers check before a launch (pure shape logic, so it
    runs here; the card tests drive the wrappers themselves)."""
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        flash_attention._check_qkv(q, k, k, "flash_attn_fwd")
    with pytest.raises(TypeError, match="float32"):
        flash_attention._check_qkv(q.double(), k, k, "flash_attn_fwd")


BWD_TOL = 1e-4  # the card tests' normwise tolerance for the backward kernels


def _tf32(x: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    """``x`` cut to TF32 (10 mantissa bits): rounded to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds, or truncated."""
    bits = x.contiguous().view(torch.int32)
    if rounded:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the tensor cores take it: "1xtf32" one
    product of the operands rounded to TF32; "3xtf32" each operand split
    into a rounded TF32 big part and a truncated TF32 remainder, and
    small·big + big·small + big·big (the backward kernels' products)."""
    a_big, b_big = _tf32(a), _tf32(b)
    if mode == "1xtf32":
        return torch.einsum(eq, a_big, b_big)
    a_small, b_small = _tf32(a - a_big, rounded=False), _tf32(b - b_big, rounded=False)
    return (torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small)
            + torch.einsum(eq, a_big, b_big))


def _tf32_flash_bwd(q, k, v, o, lse, do, causal: bool, mode: str):
    """The plain backward (``torch_flash_attn_bwd``) with every one of its
    five products taken in ``mode``."""
    heads, kv = q.shape[2], k.shape[2]
    ke, ve = flash_attention._expand_kv(k, heads), flash_attention._expand_kv(v, heads)
    s = _tf32_product("bthd,bshd->bhts", q, ke, mode) / D ** 0.5
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp(s - lse[..., None])
    dv = _tf32_product("bhts,bthd->bshd", p, do, mode)
    dp = _tf32_product("bthd,bshd->bhts", do, ve, mode)
    delta = (do * o).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    dq = _tf32_product("bhts,bshd->bthd", ds, ke, mode) / D ** 0.5
    dk = _tf32_product("bhts,bthd->bshd", ds, q, mode) / D ** 0.5
    return (dq, flash_attention._sum_groups(dk, kv), flash_attention._sum_groups(dv, kv))


@pytest.mark.parametrize("q_scale", [1.0, 8.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [4, 1])
def test_3xtf32_products_keep_the_backward_inside_the_card_tolerance(kv, causal, q_scale):
    """The precision decision behind the backward kernels, emulated here at
    the card test's shapes: with every product in 3xTF32 the gradients stay
    within the card's normwise ``BWD_TOL`` of the float32 plain backward;
    with one TF32 product (the small terms dropped) each falls outside it,
    so the card tests can tell a kernel that drops them.  ``q_scale`` 8
    makes the softmax nearly one-hot and the scores large, as the card's
    stress cases do."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(384, kv, seed=kv + 2 * causal))
    q = q * q_scale
    o, lse = flash_attention.torch_flash_attn_fwd(q, k, v, causal=causal)
    want = flash_attention.torch_flash_attn_bwd(q, k, v, o, lse, do, causal=causal)
    three = _tf32_flash_bwd(q, k, v, o, lse, do, causal, "3xtf32")
    one = _tf32_flash_bwd(q, k, v, o, lse, do, causal, "1xtf32")

    def normwise(got, ref):
        return (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())

    for name, w, g3, g1 in zip(("dq", "dk", "dv"), want, three, one):
        assert normwise(g3, w) <= BWD_TOL, name
        assert normwise(g1, w) > BWD_TOL, name


# (q shape, k shape, q dtype, whether B5 takes it); meta tensors, so the
# shapes cost no memory.
DISPATCH_CASES = {
    "f32_d128_t2048": ((1, 2048, 4, 128), (1, 2048, 2, 128), torch.float32, True),
    "f32_d128_t128_mha": ((2, 128, 4, 128), (2, 128, 4, 128), torch.float32, True),
    "bf16": ((1, 2048, 4, 128), (1, 2048, 2, 128), torch.bfloat16, False),
    "d64": ((1, 256, 4, 64), (1, 256, 4, 64), torch.float32, False),
    "d256": ((1, 256, 4, 256), (1, 256, 2, 256), torch.float32, False),
    "t192": ((1, 192, 4, 128), (1, 192, 4, 128), torch.float32, False),
    "kv_not_dividing": ((1, 128, 4, 128), (1, 128, 3, 128), torch.float32, False),
    "bh_at_limit": ((16383, 128, 4, 128), (16383, 128, 1, 128), torch.float32, True),
    "bh_over_limit": ((16385, 128, 4, 128), (16385, 128, 1, 128), torch.float32, False),
}


def _meta_qkv(case):
    q_shape, k_shape, dtype, _ = DISPATCH_CASES[case]
    q = torch.empty(q_shape, dtype=dtype, device="meta")
    k = torch.empty(k_shape, dtype=dtype, device="meta")
    return q, k, torch.empty_like(k)


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_flash_supported_is_what_the_kernels_check(case):
    """``flash_supported`` is true exactly when ``_check_qkv`` accepts."""
    q, k, v = _meta_qkv(case)
    supported = DISPATCH_CASES[case][3]
    assert flash_attention.flash_supported(q, k, v) is supported
    if supported:
        flash_attention._check_qkv(q, k, v, "flash_attn_fwd")
    else:
        with pytest.raises((TypeError, ValueError)):
            flash_attention._check_qkv(q, k, v, "flash_attn_fwd")


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_auto_sends_the_card_only_what_b5_takes(monkeypatch, case):
    """``impl="auto"`` on a card tensor (the device check patched) takes B5
    where B5 takes the inputs and the dense branch everywhere else; "flash"
    forces B5 (which raises on the card for what it does not take)."""
    from dpwa_tpu_torch.ops import ulysses

    taken = []
    monkeypatch.setattr(ulysses, "_on_card", lambda t: True)
    monkeypatch.setattr(ulysses, "flash_attention", lambda *a, **kw: taken.append("flash"))
    monkeypatch.setattr(ulysses, "dense_attention", lambda *a, **kw: taken.append("dense"))
    q, k, v = _meta_qkv(case)
    ulysses.single_device_attention(q, k, v, causal=True, impl="auto")
    ulysses.single_device_attention(q, k, v, causal=True, impl="flash")
    want = "flash" if DISPATCH_CASES[case][3] else "dense"
    assert taken == [want, "flash"]


FWD_TOL = 1e-5  # the card tests' normwise tolerance for the forward kernel
FWD_TILE, FWD_CHUNK = 64, 32  # the kernel's key tile, and its fresh sums of S over D


def _tf32_flash_fwd(q, k, v, causal: bool, mode: str):
    """The forward kernel's arithmetic: for each 64-key tile, S with its
    sum over D in fresh sums of 32 columns, the online softmax in float32,
    and P V summed fresh for the tile, added to the accumulator after its
    rescale; both products in ``mode``.  Returns ``(o, lse)``."""
    b, t, heads, d = q.shape
    ke, ve = flash_attention._expand_kv(k, heads), flash_attention._expand_kv(v, heads)
    m = torch.full((b, heads, t), float("-inf"))
    l = torch.zeros(b, heads, t)
    acc = torch.zeros(b, heads, t, d)
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, FWD_TILE):
        kt, vt = ke[:, k0:k0 + FWD_TILE], ve[:, k0:k0 + FWD_TILE]
        s = torch.zeros(b, heads, t, kt.shape[1])
        for c in range(0, d, FWD_CHUNK):
            s = s + _tf32_product("bthd,bshd->bhts", q[..., c:c + FWD_CHUNK],
                                  kt[..., c:c + FWD_CHUNK], mode)
        s = s * (1.0 / d ** 0.5)
        if causal:
            s = s.masked_fill(k0 + torch.arange(kt.shape[1])[None, :] > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _tf32_product("bhts,bshd->bhtd", p, vt, mode)
        m = m_new
    return (acc / l[..., None]).transpose(1, 2), m + torch.log(l)


@pytest.mark.parametrize("q_scale", [1.0, 8.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [4, 1])
def test_3xtf32_products_keep_the_forward_inside_the_card_tolerance(kv, causal, q_scale):
    """The precision decision behind the forward kernel (B3, B5's forward),
    emulated here: with both products in 3xTF32, O and lse stay within the
    card's normwise ``FWD_TOL`` of the float32 plain forward; with one TF32
    product each falls outside it.  ``q_scale`` 8 makes the scores large and
    the softmax nearly one-hot, as the card's stress cases do."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(384, kv, seed=kv + 2 * causal))
    q = q * q_scale
    want_o, want_lse = flash_attention.torch_flash_attn_fwd(q, k, v, causal=causal)

    def normwise(got, ref):
        return (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())

    o3, lse3 = _tf32_flash_fwd(q, k, v, causal, "3xtf32")
    o1, lse1 = _tf32_flash_fwd(q, k, v, causal, "1xtf32")
    assert normwise(o3, want_o) <= FWD_TOL and normwise(lse3, want_lse) <= FWD_TOL
    assert normwise(o1, want_o) > FWD_TOL and normwise(lse1, want_lse) > FWD_TOL
