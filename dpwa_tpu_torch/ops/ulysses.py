"""Single-device attention (the port of part of :mod:`dpwa_tpu.ops.ulysses`).

:func:`single_device_attention` is the attention of the Llama model's
single-device path: layout ``[B, T, heads, D]``, grouped-query K/V allowed,
and the reference's ``auto | flash | dense`` dispatch with the card in the
TPU's place.  Its flash branch is the kernel B5
(:mod:`dpwa_tpu_torch.ops.flash_attention`); its dense branch is the
masked-softmax einsum in float32, a copy of the reference's.

``ulysses_attention_local`` (the all-to-all sequence-parallel form) waits
for the sequence-parallel path of the port.
"""

from __future__ import annotations

import math

import torch

from dpwa_tpu_torch.ops.flash_attention import flash_attention

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


def single_device_attention(q, k, v, *, causal: bool, impl: str = "auto") -> torch.Tensor:
    """Attention over ``q [B, T, h, D]`` and ``k, v [B, T, kv, D]`` (``kv``
    dividing ``h``).  ``impl``: "flash" forces B5 (its plain version on CPU
    tensors), "auto" takes B5 for a CUDA tensor when ``D`` and ``T`` are
    multiples of 128 (the reference's eligibility), and anything else runs
    :func:`dense_attention`."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    _, T, _, D = q.shape
    use_flash = impl == "flash" or (
        impl == "auto" and q.device.type == "cuda" and D % 128 == 0 and T % 128 == 0
    )
    if use_flash:
        return flash_attention(q, k, v, causal=causal)
    return dense_attention(q, k, v, causal=causal)
