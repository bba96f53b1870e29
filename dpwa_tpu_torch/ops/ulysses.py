"""Single-device and Ulysses attention (the port of
:mod:`dpwa_tpu.ops.ulysses`).

:func:`single_device_attention` is the attention of the Llama model's
single-device path: layout ``[B, T, heads, D]``, grouped-query K/V allowed,
and the reference's ``auto | flash | dense`` dispatch with the card in the
TPU's place.  Its flash branch is the kernel B5
(:mod:`dpwa_tpu_torch.ops.flash_attention`); its dense branch is the
masked-softmax einsum in float32, a copy of the reference's.

:func:`ulysses_attention_local` is the all-to-all sequence-parallel form
over a virtual axis of ``sp`` ranks: the two all-to-alls become reshapes,
and rank r's head-sharded attention over the whole sequence is batch entry
r of one :func:`single_device_attention` call (so, on the card, of one B5
launch for every rank).
"""

from __future__ import annotations

import math

import torch

from dpwa_tpu_torch.ops.flash_attention import flash_attention, flash_supported

IMPLS = ("auto", "flash", "dense")


def dense_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """The reference's einsum branch: GQA expanded, scores and softmax in
    float32 (scores divided by ``√D`` rounded to float32), the output cast
    back to ``q``'s dtype."""
    B, T, h, D = q.shape
    if k.shape[2] != h:
        rep = h // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def single_device_attention(q, k, v, *, causal: bool, impl: str = "auto") -> torch.Tensor:
    """Attention over ``q [B, T, h, D]`` and ``k, v [B, T, kv, D]`` (``kv``
    dividing ``h``).  ``impl``: "flash" forces B5 (its plain version on CPU
    tensors; on the card it raises on inputs B5 does not take), "auto"
    takes B5 for a CUDA tensor that B5 takes (:func:`~dpwa_tpu_torch.ops.
    flash_attention.flash_supported`: float32, D 128, T a multiple of 128;
    the reference's auto likewise takes its library kernel only where that
    kernel works), and anything else runs :func:`dense_attention`."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    use_flash = impl == "flash" or (impl == "auto" and _on_card(q) and flash_supported(q, k, v))
    if use_flash:
        return flash_attention(q, k, v, causal=causal)
    return dense_attention(q, k, v, causal=causal)


def ulysses_attention_local(q, k, v, sp: int, causal: bool = True, impl: str = "auto"):
    """Ulysses attention over ``sp`` virtual ranks: ``q [B, T, H, D]`` and
    ``k, v [B, T, KV, D]`` hold every rank's contiguous block; returns
    ``[B, T, H, D]``.  Rank r attends with heads ``[r·H/sp, (r+1)·H/sp)``
    over the whole sequence (grouped K/V: ``KV/sp`` groups each, or K/V
    expanded to H first when ``KV % sp``, as the reference does)."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    if h % sp:
        raise ValueError(
            f"ulysses needs n_heads {h} divisible by sp={sp} "
            "(attention is head-sharded after the all-to-all)"
        )
    if kv % sp:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)

    def seq_to_heads(x):  # [B, T, X, D] -> [B·sp, T, X/sp, D], rank r's heads at b·sp + r
        return x.unflatten(2, (sp, -1)).transpose(1, 2).flatten(0, 1)

    out = single_device_attention(
        seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal=causal, impl=impl
    )
    return out.unflatten(0, (b, sp)).transpose(1, 2).flatten(2, 3)
