"""Ring attention over a virtual sequence-parallel axis (the port of
:mod:`dpwa_tpu.ops.ring_attention`).

The reference shards a sequence into contiguous blocks over a mesh axis and
rotates the K/V blocks around it while an online softmax accumulates.  On
one card the axis is virtual: q, k and v hold the whole sequence, ``sp``
blocks of ``T_local`` rows, rank i holding global positions ``[i·T_local,
(i+1)·T_local)``, and at hop h every rank reads the block of rank
``(i − h) mod sp`` in place.

:func:`ring_attention_local` keeps the reference's dispatch
(``ring_attention.py:116-129``): on the card an eligible block runs every
hop through the kernels B3/B4 (:func:`~dpwa_tpu_torch.ops.flash_ring.
ring_flash_attention`); ``impl="flash"`` forces that path on the CPU too
(its plain hops, the reference's twins); everything else, and any explicit
``q_chunk``, runs the q-chunked einsum hop below, which autograd
differentiates (the reference rematerialises each hop with
``jax.checkpoint``; here the score panels are kept for the backward).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dpwa_tpu_torch.ops.flash_ring import flash_ring_supported, ring_flash_attention

IMPLS = ("auto", "flash", "xla")


def _block_attn(q, k, v, scale, qpos, kpos, causal):
    """One hop's partial attention for every rank: ``q [B, R, T, H, D]``
    against ``k, v [B, R, S, KV, D]`` (rank r's source block), positions
    ``[R, T]`` and ``[R, S]``.  Returns the scores' max ``[B, R, H, T]``,
    the row sums, and ``exp(scores) @ v`` ``[B, R, T, H, D]`` (the
    reference returns the last two the other way round)."""
    if k.shape[3] != q.shape[3]:
        rep = q.shape[3] // k.shape[3]
        k = k.repeat_interleave(rep, dim=3)
        v = v.repeat_interleave(rep, dim=3)
    s = torch.einsum("brthd,brshd->brhts", q, k) * scale
    if causal:
        mask = kpos[:, None, :] <= qpos[:, :, None]  # [R, T, S]
        s = s.masked_fill(~mask[None, :, None], float("-inf"))
    m = s.amax(-1)
    # Guard fully-masked rows (no valid keys in this block yet).
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    o = torch.einsum("brhts,brshd->brthd", p, v)
    return m, p.sum(-1), o


def _auto_q_chunk(t: int) -> int:
    """The reference's default query chunk: the largest power-of-two
    divisor of ``t`` up to 256, or 0 (no chunking) for blocks of 512 or
    fewer rows."""
    if t <= 512:
        return 0
    c = 256
    while c > 1 and t % c:
        c //= 2
    return c if c > 1 else 0


def _merge_partials(m, l, o, m_blk, l_blk, o_blk):
    """Online-softmax combine of two (max, denominator, weighted sum)
    partials."""
    m_new = torch.maximum(m, m_blk)
    c_old = torch.exp(m - m_new)
    c_blk = torch.exp(m_blk - m_new)
    c_old = torch.where(torch.isfinite(c_old), c_old, 0.0)
    c_blk = torch.where(torch.isfinite(c_blk), c_blk, 0.0)
    l_new = l * c_old + l_blk * c_blk
    o_new = o * c_old.transpose(2, 3)[..., None] + o_blk * c_blk.transpose(2, 3)[..., None]
    return m_new, l_new, o_new


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sp: int,
    causal: bool = True,
    q_chunk: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Exact ring attention over ``sp`` virtual ranks.

    ``q [B, T, H, D]`` and ``k, v [B, T, KV, D]`` hold every rank's block
    of ``T_local = T / sp`` rows (grouped K/V allowed); returns ``[B, T, H,
    D]`` in q's dtype.  ``impl``: "auto" runs the hops through B3/B4 on the
    card when :func:`~dpwa_tpu_torch.ops.flash_ring.flash_ring_supported`
    holds for a block; "flash" asks for the same (on the CPU: the plain
    hops); "xla" keeps the q-chunked einsum hop, as does an explicit
    ``q_chunk`` (None picks :func:`_auto_q_chunk`, 0 disables chunking)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    b, t_all, h, d = q.shape
    if t_all % sp:
        raise ValueError(f"T = {t_all} is not divisible by sp = {sp}")
    t = t_all // sp
    if impl != "xla" and q_chunk is None:
        on_card = q.device.type == "cuda"
        if (on_card and flash_ring_supported((b, t, h, d))) or (not on_card and impl == "flash"):
            return ring_flash_attention(q, k, v, sp, causal)
    if q_chunk is None:
        q_chunk = _auto_q_chunk(t)
    if q_chunk and t % q_chunk:
        raise ValueError(f"q_chunk {q_chunk} must divide T_local {t}")
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))  # in float32, as jnp
    q32 = q.float().unflatten(1, (sp, t))  # [B, R, T, H, D]
    k32 = k.float().unflatten(1, (sp, t))
    v32 = v.float().unflatten(1, (sp, t))
    ranks = torch.arange(sp, device=q.device)
    qpos = ranks[:, None] * t + torch.arange(t, device=q.device)  # [R, T]
    m = torch.full((b, sp, h, t), float("-inf"), device=q.device)
    l = torch.zeros(b, sp, h, t, device=q.device)
    o = torch.zeros_like(q32)
    for hop in range(sp):
        # Rank r holds the block of rank (r - hop) mod sp.
        k_cur, v_cur = (torch.roll(x, hop, dims=1) for x in (k32, v32))
        kpos = torch.roll(qpos, hop, dims=0)
        if not q_chunk:
            m, l, o = _merge_partials(m, l, o, *_block_attn(q32, k_cur, v_cur, scale, qpos, kpos, causal))
            continue
        parts = []
        for c in range(0, t, q_chunk):
            rows = slice(c, c + q_chunk)
            blk = _block_attn(q32[:, :, rows], k_cur, v_cur, scale, qpos[:, rows], kpos, causal)
            parts.append(_merge_partials(m[..., rows], l[..., rows], o[:, :, rows], *blk))
        m = torch.cat([p[0] for p in parts], -1)
        l = torch.cat([p[1] for p in parts], -1)
        o = torch.cat([p[2] for p in parts], 2)
    out = o / l.clamp_min(1e-20).transpose(2, 3)[..., None]
    return out.reshape(b, t_all, h, d).to(q.dtype)


def full_attention_reference(q, k, v, causal: bool = True) -> torch.Tensor:
    """O(T²) single-device attention (``q, k, v [B, T, H, D]``), the
    reference's parity yardstick."""
    _, t, _, d = q.shape
    s = torch.einsum("bthd,bshd->bhts", q, k) / float(np.sqrt(np.float32(d)))
    if causal:
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s.float(), -1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)
