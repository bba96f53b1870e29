"""Ring-attention hops (B3, B4) and the flash ring over a virtual sp axis.

The port of :mod:`dpwa_tpu.ops.flash_ring`.  The reference runs one device
per sequence-parallel rank: each holds a ``T_local`` block of q, k and v,
and over ``sp`` hops the K/V blocks rotate by ``ppermute`` while every hop
runs JAX's library TPU flash kernels on (its q block, the K/V block held).
On one card the sp axis is virtual: q, k and v hold the whole sequence,
``sp`` blocks of ``T_local`` rows, and at hop ``h`` rank ``me`` reads the
block of rank ``src = (me − h) mod sp`` in place, so the ring moves no
bytes.  The arithmetic is the reference's:

- a hop's case for rank ``me`` (the reference's ``lax.cond``): ``src > me``
  a future block, skipped (``o = 0``, ``lse = −1e30``); ``src == me`` the
  diagonal block, causal; ``src < me`` a past block, full;
- hop results merge by logsumexp weights (``flash_ring.py:327-331``);
- the backward feeds every hop the GLOBAL ``lse`` and ``di = rowsum(out ·
  dout)``, so ``p = exp(s − lse)`` is the global softmax restricted to the
  block held and the hop's (dq, dk, dv) are exact global gradients: dq adds
  up per rank, dk and dv on the source block, in hop order.

Two wrappers around the hand-written CUDA kernels of
``csrc/flash_attention.cu`` run one hop for every rank in one launch, each
beside its plain PyTorch version (the ports of the reference's jnp twins
``_hop_fwd_jnp`` / ``_hop_bwd_jnp``, which run on the CPU):

- :func:`ring_hop_fwd` (B3) → the hop's ``(o, lse)``;
- :func:`ring_hop_bwd_` (B4) → adds the hop's gradients into ``dq``,
  ``dk``, ``dv`` (two kernel launches).

A launch can also cover a panel of each block (``rows`` rows from
``q_off`` in each query block against ``rows`` from ``k_off`` in each key
block): the zigzag layout's half stripes (:mod:`.zigzag_ring`), which share
the ring below through its hop plans.  Layout is the model's ``[B, T,
heads, D]``; grouped K/V are read in place.  A wrapper takes its plain
version only for CPU tensors; for a CUDA tensor it launches the kernels or
raises.  Each wrapper call that launches adds one to its ``launches``.

:class:`RingFlashAttention` is the ring as a ``torch.autograd.Function``
with a ``vmap`` rule that folds stacked peers into the batch, as
:class:`~dpwa_tpu_torch.ops.flash_attention.FlashAttention` does.
"""

from __future__ import annotations

import torch

from dpwa_tpu_torch.ops import flash_attention as _fa
from dpwa_tpu_torch.ops.flash_attention import HEAD_DIMS, T_MULTIPLE, _fold

SKIP, DIAG, FULL = 0, 1, 2  # a rank's case in a hop
NEG_INF = -1e30  # the reference's _NEG_INF: a skipped block's lse
Q_CHUNK = 512  # the reference's _JNP_Q_CHUNK: the plain hops' query panel
MAX_SP = 32  # ranks whose cases fit the kernels' 64-bit case word
LAYOUTS = ("contiguous", "zigzag")


def flash_ring_supported(q_shape) -> bool:
    """Whether the hop kernels take a ``[B, T_local, H, D]`` block (or a
    zigzag half stripe): ``T_local`` a multiple of 128, as the reference's
    ``flash_ring_supported`` asks, and ``D`` one the kernels are built for."""
    _, t, _, d = q_shape
    return t > 0 and t % T_MULTIPLE == 0 and d in HEAD_DIMS


def hop_cases(sp: int, hop: int, rule: str) -> tuple[int, ...]:
    """Every rank's case at ``hop``.  ``rule`` "causal": a later source
    block is skipped, the rank's own is diagonal, an earlier one full (the
    contiguous causal ring, and the zigzag early stripes); "reverse": the
    other way round (the zigzag late stripes against late stripes); "full":
    every block full."""
    if rule not in ("causal", "reverse", "full"):
        raise ValueError(f"rule must be causal|reverse|full, got {rule!r}")
    cases = []
    for me in range(sp):
        src = (me - hop) % sp
        if rule == "full":
            cases.append(FULL)
        elif src == me:
            cases.append(DIAG)
        elif (src > me) == (rule == "causal"):
            cases.append(SKIP)
        else:
            cases.append(FULL)
    return tuple(cases)


# ---------------------------------------------------------------------------
# One hop on one rank, layout [B, H, T, D]: ports of the reference's twins.
# ---------------------------------------------------------------------------


def _hop_fwd_panel(q, k, v, causal: bool, scale: float, row0: int):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = row0 + torch.arange(q.shape[2], device=q.device)
        mask = torch.arange(k.shape[2], device=q.device)[None, :] <= rows[:, None]
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l[..., None]
    return o, m + torch.log(l)


def torch_hop_fwd(q, k, v, causal: bool, scale: float):
    """The reference's ``_hop_fwd_jnp``: ``(o, lse)`` of ``q`` against one
    block ``k, v`` (``[B, H, T, D]``, k and v with q's heads), causal
    within the block or not, with queries in panels of :data:`Q_CHUNK`."""
    t = q.shape[2]
    parts = [
        _hop_fwd_panel(q[:, :, r:r + Q_CHUNK], k, v, causal, scale, r)
        for r in range(0, t, Q_CHUNK)
    ]
    return torch.cat([o for o, _ in parts], 2), torch.cat([lse for _, lse in parts], 2)


def _hop_bwd_panel(q, k, v, lse, do, di, causal, scale, row0):
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    if causal:
        rows = row0 + torch.arange(q.shape[2], device=q.device)
        mask = torch.arange(k.shape[2], device=q.device)[None, :] <= rows[:, None]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse[..., None])  # the global softmax, this block's columns
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v32)
    ds = (dp - di[..., None]) * p * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32)
    return dq, dk, dv


def torch_hop_bwd(q, k, v, lse, do, di, causal: bool, scale: float):
    """The reference's ``_hop_bwd_jnp``: one block's exact share of the
    global ``(dq, dk, dv)`` from the global ``lse`` and ``di`` (``[B, H,
    T]``), in query panels of :data:`Q_CHUNK`."""
    t = q.shape[2]
    dqs, dk, dv = [], 0.0, 0.0
    for r in range(0, t, Q_CHUNK):
        sl = slice(r, r + Q_CHUNK)
        dq_c, dk_c, dv_c = _hop_bwd_panel(
            q[:, :, sl], k, v, lse[:, :, sl], do[:, :, sl], di[:, :, sl], causal, scale, r
        )
        dqs.append(dq_c)
        dk, dv = dk + dk_c, dv + dv_c
    return torch.cat(dqs, 2), dk, dv


# ---------------------------------------------------------------------------
# One hop for every rank, layout [B, T, heads, D]: the kernels' contract.
# ---------------------------------------------------------------------------


def _scale(d: int) -> float:
    return 1.0 / (d ** 0.5)  # the reference's float(1.0 / (D ** 0.5))


def _panel(t: int, sp: int, hop: int, cases, rows, q_off: int, k_off: int):
    """``(t_local, rows)`` of a hop over ``t`` rows in ``sp`` blocks;
    raises on a panel or a case list that does not fit."""
    if not 1 <= sp <= MAX_SP:
        raise ValueError(f"sp = {sp} is not in [1, {MAX_SP}]")
    if t % sp:
        raise ValueError(f"T = {t} is not divisible by sp = {sp}")
    t_local = t // sp
    rows = t_local if rows is None else rows
    if not 0 <= hop < sp:
        raise ValueError(f"hop {hop} is not in [0, {sp})")
    if len(cases) != sp or any(c not in (SKIP, DIAG, FULL) for c in cases):
        raise ValueError(f"cases must be {sp} of SKIP, DIAG, FULL; got {cases}")
    for off in (q_off, k_off):
        if rows < 1 or off < 0 or off + rows > t_local:
            raise ValueError(f"panel rows [{off}, {off + rows}) exceed the block of {t_local}")
    return t_local, rows


def torch_ring_hop_fwd(q, k, v, *, sp: int, hop: int, cases, rows=None, q_off=0, k_off=0):
    """Plain version of :func:`ring_hop_fwd`."""
    b, t, h, d = q.shape
    t_local, rows = _panel(t, sp, hop, cases, rows, q_off, k_off)
    o = torch.zeros(b, sp * rows, h, d, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, sp * rows), NEG_INF, dtype=torch.float32, device=q.device)
    for me, case in enumerate(cases):
        if case == SKIP:
            continue
        src = (me - hop) % sp
        qr = slice(me * t_local + q_off, me * t_local + q_off + rows)
        kr = slice(src * t_local + k_off, src * t_local + k_off + rows)
        kp, vp = (_fa._expand_kv(x[:, kr], h).transpose(1, 2) for x in (k, v))
        o_r, lse_r = torch_hop_fwd(q[:, qr].transpose(1, 2), kp, vp, case == DIAG, _scale(d))
        o[:, me * rows:(me + 1) * rows] = o_r.transpose(1, 2)
        lse[:, :, me * rows:(me + 1) * rows] = lse_r
    return o, lse


def torch_ring_hop_bwd_(
    q, k, v, lse, do, di, dq, dk, dv, *, sp: int, hop: int, cases, rows=None, q_off=0, k_off=0
) -> None:
    """Plain version of :func:`ring_hop_bwd_`."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    t_local, rows = _panel(t, sp, hop, cases, rows, q_off, k_off)
    for me, case in enumerate(cases):
        if case == SKIP:
            continue
        src = (me - hop) % sp
        qr = slice(me * t_local + q_off, me * t_local + q_off + rows)
        kr = slice(src * t_local + k_off, src * t_local + k_off + rows)
        kp, vp = (_fa._expand_kv(x[:, kr], h).transpose(1, 2) for x in (k, v))
        dq_i, dk_i, dv_i = torch_hop_bwd(
            q[:, qr].transpose(1, 2), kp, vp, lse[:, :, qr], do[:, qr].transpose(1, 2),
            di[:, :, qr], case == DIAG, _scale(d),
        )
        dq[:, qr] += dq_i.transpose(1, 2)
        dk[:, kr] += _fa._sum_groups(dk_i.transpose(1, 2), kv)
        dv[:, kr] += _fa._sum_groups(dv_i.transpose(1, 2), kv)


def _case_word(cases) -> int:
    return sum(c << (2 * r) for r, c in enumerate(cases))


def _check_hop(q, k, v, sp, hop, cases, rows, q_off, k_off, name):
    """The kernels' shapes of one hop; raises on anything they do not take."""
    b, t, h, kv, d = _fa._check_qkv(q, k, v, name)
    t_local, rows = _panel(t, sp, hop, cases, rows, q_off, k_off)
    if rows % T_MULTIPLE:
        raise ValueError(f"{name}: panel rows {rows} are not a multiple of {T_MULTIPLE}")
    return b, t, h, kv, d, t_local, rows


def ring_hop_fwd(q, k, v, *, sp: int, hop: int, cases, rows=None, q_off=0, k_off=0):
    """B3: one ring hop for every rank.  q ``[B, T, H, D]`` and k, v ``[B,
    T, KV, D]`` hold ``sp`` blocks of ``T_local = T / sp`` rows; rank
    ``me``'s query rows ``[q_off, q_off + rows)`` of block ``me`` attend to
    the rows ``[k_off, k_off + rows)`` of block ``(me − hop) mod sp`` in
    case ``cases[me]``.  Returns ``o [B, sp·rows, H, D]`` and ``lse [B, H,
    sp·rows]`` in float32, rank after rank (``rows`` defaults to
    ``T_local``); a skipped rank's are 0 and −1e30.  On the card: float32,
    D 128, ``rows`` a multiple of 128."""
    if q.device.type == "cpu":
        return torch_ring_hop_fwd(
            q, k, v, sp=sp, hop=hop, cases=cases, rows=rows, q_off=q_off, k_off=k_off
        )
    if q.device.type != "cuda":
        raise ValueError(f"ring_hop_fwd: unsupported device {q.device}")
    b, t, h, kv, d, t_local, rows = _check_hop(
        q, k, v, sp, hop, cases, rows, q_off, k_off, "ring_hop_fwd"
    )
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty(b, sp * rows, h, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(b, h, sp * rows, dtype=torch.float32, device=q.device)
    lib = _fa._lib()
    with torch.cuda.device(q.device):
        err = lib.dpwa_ring_hop_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, sp, t_local, h, kv, d, _scale(d), hop, rows, q_off, k_off,
            _case_word(cases), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _fa._check_launch(lib, "ring_hop_fwd", err)
    ring_hop_fwd.launches += 1
    return o, lse


def ring_hop_bwd_(
    q, k, v, lse, do, di, dq, dk, dv, *, sp: int, hop: int, cases, rows=None, q_off=0, k_off=0
) -> None:
    """B4: adds one ring hop's gradients, for every rank, into ``dq`` (like
    q) at the query rows and into ``dk``, ``dv`` (like k, v) at the source
    blocks' rows.  ``lse`` and ``di = rowsum(out·do)`` (``[B, H, T]``) are
    the whole ring's; ``do`` is like q.  Panels and cases as
    :func:`ring_hop_fwd`.  On the card the accumulators must be contiguous
    float32."""
    if q.device.type == "cpu":
        return torch_ring_hop_bwd_(
            q, k, v, lse, do, di, dq, dk, dv,
            sp=sp, hop=hop, cases=cases, rows=rows, q_off=q_off, k_off=k_off,
        )
    if q.device.type != "cuda":
        raise ValueError(f"ring_hop_bwd_: unsupported device {q.device}")
    b, t, h, kv, d, t_local, rows = _check_hop(
        q, k, v, sp, hop, cases, rows, q_off, k_off, "ring_hop_bwd_"
    )
    for x, like, what in ((do, q, "do"), (dq, q, "dq"), (dk, k, "dk"), (dv, v, "dv"),
                          (lse, None, "lse"), (di, None, "di")):
        shape = (b, h, t) if like is None else like.shape
        if x.shape != shape or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"ring_hop_bwd_: {what} must be float32 {tuple(shape)} on {q.device}")
    for x, what in ((dq, "dq"), (dk, "dk"), (dv, "dv")):
        if not x.is_contiguous():
            raise ValueError(f"ring_hop_bwd_: {what} is added into in place and must be contiguous")
    q, k, v, lse, do, di = (x.contiguous() for x in (q, k, v, lse, do, di))
    lib = _fa._lib()
    with torch.cuda.device(q.device):
        err = lib.dpwa_ring_hop_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sp, t_local, h, kv, d, _scale(d), hop, rows, q_off, k_off,
            _case_word(cases), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _fa._check_launch(lib, "ring_hop_bwd_", err)
    ring_hop_bwd_.launches += 1


ring_hop_fwd.launches = 0
ring_hop_bwd_.launches = 0


def reset_launch_counts() -> None:
    """Set both wrappers' ``launches`` counts to 0."""
    ring_hop_fwd.launches = 0
    ring_hop_bwd_.launches = 0


# ---------------------------------------------------------------------------
# The ring over the virtual axis.
# ---------------------------------------------------------------------------


def hop_plan(layout: str, t_local: int, causal: bool):
    """``(stripes, panels)`` of a layout: the query stripes of a block as
    ``(offset, rows)``, and the panels each hop runs, in order, as
    ``(stripe, key offset, rule)``.  Contiguous: one stripe, one panel.
    Zigzag (each block holds global chunks i and 2n−1−i, causal only): the
    early stripe against early keys (causal), then the late stripe against
    early keys (full) and against late keys (reversed) —
    ``zigzag_ring.py:166-194``."""
    if layout == "contiguous":
        return ((0, t_local),), ((0, 0, "causal" if causal else "full"),)
    if layout == "zigzag":
        if not causal:
            raise ValueError("the zigzag layout is causal by construction")
        c = t_local // 2
        return ((0, c), (c, c)), ((0, 0, "causal"), (1, 0, "full"), (1, c, "reverse"))
    raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")


def _hops(impl: str):
    if impl == "flash":
        return ring_hop_fwd, ring_hop_bwd_
    if impl == "jnp":  # the reference's twin arithmetic, asked for by name
        return torch_ring_hop_fwd, torch_ring_hop_bwd_
    raise ValueError(f"impl must be flash|jnp, got {impl!r}")


def _merge(out, lse, o_i, lse_i):
    """The reference's logsumexp merge of a hop into a stripe's
    accumulators (``out [B, T, H, D]``, ``lse [B, H, T]``)."""
    lse_new = torch.logaddexp(lse, lse_i)
    w_old = torch.exp(torch.clamp_max(lse - lse_new, 0.0)).transpose(1, 2)[..., None]
    w_new = torch.exp(torch.clamp_max(lse_i - lse_new, 0.0)).transpose(1, 2)[..., None]
    return out * w_old + o_i * w_new, lse_new


def ring_forward(q, k, v, sp: int, layout: str, causal: bool, impl: str = "flash"):
    """``(out32 [B, T, H, D], lse [B, H, T])`` of the ring over ``sp``
    blocks of the float32 ``q, k, v``: every hop's panels through B3 (or
    the plain hops) and the logsumexp merge."""
    b, t, h, d = q.shape
    hop_fwd, _ = _hops(impl)
    stripes, panels = hop_plan(layout, t // sp, causal)
    outs = [q.new_zeros(b, sp * rows, h, d) for _, rows in stripes]
    lses = [q.new_full((b, h, sp * rows), NEG_INF) for _, rows in stripes]
    for hop in range(sp):
        for stripe, k_off, rule in panels:
            q_off, rows = stripes[stripe]
            o_i, lse_i = hop_fwd(
                q, k, v, sp=sp, hop=hop, cases=hop_cases(sp, hop, rule),
                rows=rows, q_off=q_off, k_off=k_off,
            )
            outs[stripe], lses[stripe] = _merge(outs[stripe], lses[stripe], o_i, lse_i)
    if len(stripes) == 1:
        return outs[0], lses[0]
    # Each block is its stripes in order: [B, sp, stripe, rows, ...].
    out = torch.stack([o.unflatten(1, (sp, -1)) for o in outs], 2).reshape(b, t, h, d)
    lse = torch.stack([x.unflatten(2, (sp, -1)) for x in lses], 3).reshape(b, h, t)
    return out, lse


def ring_backward(q, k, v, out32, lse, g, sp: int, layout: str, causal: bool, impl: str = "flash"):
    """``(dq, dk, dv)`` in float32 of the ring: ``di = rowsum(out32·g)``
    once, then every hop's panels through B4 (or the plain hops), adding
    into the three gradients."""
    _, hop_bwd = _hops(impl)
    stripes, panels = hop_plan(layout, q.shape[1] // sp, causal)
    do = g.float().contiguous()
    di = (out32 * do).sum(-1).transpose(1, 2).contiguous()  # [B, H, T]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for hop in range(sp):
        for stripe, k_off, rule in panels:
            q_off, rows = stripes[stripe]
            hop_bwd(
                q, k, v, lse, do, di, dq, dk, dv, sp=sp, hop=hop,
                cases=hop_cases(sp, hop, rule), rows=rows, q_off=q_off, k_off=k_off,
            )
    return dq, dk, dv


class RingFlashAttention(torch.autograd.Function):
    """``(out32, lse) = RingFlashAttention.apply(q, k, v, sp, layout,
    causal, impl)`` on float32 ``q [B, T, H, D]`` and ``k, v [B, T, KV,
    D]``; differentiable in q, k and v (``lse`` is not)."""

    @staticmethod
    def forward(q, k, v, sp, layout, causal, impl):
        return ring_forward(q, k, v, sp, layout, causal, impl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, sp, layout, causal, impl = inputs
        out32, lse = output
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.ring = (sp, layout, causal, impl)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, g, _glse):
        q, k, v, out32, lse = ctx.saved_tensors
        grads = RingFlashAttentionBackward.apply(q, k, v, out32, lse, g, *ctx.ring)
        return (*grads, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, sp, layout, causal, impl):
        n = info.batch_size
        q, k, v = (_fold(t, d, n) for t, d in zip((q, k, v), in_dims[:3]))
        out, lse = RingFlashAttention.apply(q, k, v, sp, layout, causal, impl)
        return (out.unflatten(0, (n, -1)), lse.unflatten(0, (n, -1))), (0, 0)


class RingFlashAttentionBackward(torch.autograd.Function):
    """The ring's backward as a function of its inputs, so that it also
    batches under ``vmap``."""

    @staticmethod
    def forward(q, k, v, out32, lse, g, sp, layout, causal, impl):
        return ring_backward(q, k, v, out32, lse, g, sp, layout, causal, impl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("ring attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out32, lse, g, sp, layout, causal, impl):
        n = info.batch_size
        args = [_fold(t, d, n) for t, d in zip((q, k, v, out32, lse, g), in_dims[:6])]
        grads = RingFlashAttentionBackward.apply(*args, sp, layout, causal, impl)
        return tuple(x.unflatten(0, (n, -1)) for x in grads), (0, 0, 0)


def _resolve_impl(impl, block_shape, device) -> str:
    """The reference's ``_resolve_impl`` with the card in the TPU's place:
    "flash" or "jnp" as asked; None takes the kernels on the card when
    :func:`flash_ring_supported` holds for ``block_shape``, else the twins."""
    if impl in ("flash", "jnp"):
        return impl
    if impl is not None:
        raise ValueError(f"impl must be flash|jnp|None, got {impl!r}")
    return "flash" if device.type == "cuda" and flash_ring_supported(block_shape) else "jnp"


def ring_flash_attention(q, k, v, sp: int, causal: bool = True, impl=None,
                         layout: str = "contiguous") -> torch.Tensor:
    """Flash-kernel ring attention over a virtual axis of ``sp`` ranks: the
    port of ``ring_flash_attention_local``.  ``q [B, T, H, D]`` and ``k, v
    [B, T, KV, D]`` hold every rank's block (rank i: global positions
    ``[i·T/sp, (i+1)·T/sp)``); returns the attention output in q's
    layout and dtype.  ``impl``: "flash", "jnp" or None, as :func:`_resolve_impl`."""
    b, t, h, d = q.shape
    if t % sp:
        raise ValueError(f"T = {t} is not divisible by sp = {sp}")
    block = (b, t // sp // (2 if layout == "zigzag" else 1), h, d)
    which = _resolve_impl(impl, block, q.device)
    out32, _ = RingFlashAttention.apply(q.float(), k.float(), v.float(), sp, layout, causal, which)
    return out32.to(q.dtype)
