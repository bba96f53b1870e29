"""Flash attention (B5): float32 causal or full attention with its gradient.

The port of the flash branch of :func:`dpwa_tpu.ops.ulysses.
single_device_attention`, which calls JAX's library TPU flash kernel.  Two
wrappers around the hand-written CUDA kernels of ``csrc/flash_attention.cu``,
each beside its plain PyTorch version:

- :func:`flash_attn_fwd` → ``(o, lse)``: ``o = softmax(scale·q kᵀ) v`` and the
  rows' log-sum-exp ``lse`` (``[B, H, T]``), ``scale = 1/√D``;
- :func:`flash_attn_bwd` → ``(dq, dk, dv)`` from ``q, k, v, o, lse`` and
  ``do`` (three kernel launches: ``Δ = rowsum(do∘o)``, dK/dV, dQ; the last
  two take their products on the tensor cores in 3xTF32, which keeps
  float32's accuracy).

Layout is the model's ``[B, T, heads, D]``; ``k`` and ``v`` may carry fewer
heads than ``q`` (grouped-query attention, read in place by the kernels).
A wrapper takes its plain version only for CPU tensors; for a CUDA tensor it
launches the kernels or raises.  Each wrapper call that launches adds one to
its ``launches`` count.

:class:`FlashAttention` is the ``torch.autograd.Function`` over the two, in
the functorch style (``setup_context`` and a ``vmap`` rule that folds the
mapped axis into the batch), so ``torch.func.vmap(grad(...))`` over stacked
peers makes one forward and one backward call per layer for all peers.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

_MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y: B·heads
HEAD_DIMS = (128,)  # the Llama path's head dim; the kernels build no other
T_MULTIPLE = 128  # the reference's eligibility: T a multiple of 128


def _expand_kv(t: torch.Tensor, heads: int) -> torch.Tensor:
    """Grouped ``[B, T, KV, D]`` keys or values expanded to ``heads`` (each
    group's head repeated, as ``jnp.repeat`` on axis 2)."""
    kv = t.shape[2]
    return t if kv == heads else t.repeat_interleave(heads // kv, dim=2)


def _sum_groups(t: torch.Tensor, kv: int) -> torch.Tensor:
    """``[B, T, H, D]`` per-head gradients summed back onto ``kv`` groups."""
    heads = t.shape[2]
    return t if kv == heads else t.unflatten(2, (kv, heads // kv)).sum(3)


def _scores(q, k, causal: bool) -> torch.Tensor:
    """``scale · q kᵀ`` as ``[B, H, T, S]``, masked to -inf above the
    diagonal when causal."""
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(q.shape[-1])
    if causal:
        t, n = s.shape[-2:]
        keep = torch.ones(t, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def torch_flash_attn_fwd(q, k, v, *, causal: bool):
    """Plain version of :func:`flash_attn_fwd`: ``(o, lse)``."""
    heads = q.shape[2]
    s = _scores(q, _expand_kv(k, heads), causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhts,bshd->bthd", p, _expand_kv(v, heads))
    return o, lse


def torch_flash_attn_bwd(q, k, v, o, lse, do, *, causal: bool):
    """Plain version of :func:`flash_attn_bwd`: ``(dq, dk, dv)``."""
    heads, kv, scale = q.shape[2], k.shape[2], 1.0 / math.sqrt(q.shape[-1])
    ke, ve = _expand_kv(k, heads), _expand_kv(v, heads)
    p = torch.exp(_scores(q, ke, causal) - lse[..., None])
    dv = torch.einsum("bhts,bthd->bshd", p, do)
    dp = torch.einsum("bthd,bshd->bhts", do, ve)
    delta = (do * o).sum(-1).transpose(1, 2)  # [B, H, T]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, ke) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q) * scale
    return dq, _sum_groups(dk, kv), _sum_groups(dv, kv)


_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library (B5, and the ring hops B3 and B4 of
    :mod:`dpwa_tpu_torch.ops.flash_ring`), built and loaded at the first
    launch."""
    from dpwa_tpu_torch.ops import _build

    lib = _build.load("flash_attention.cu")
    lib.dpwa_flash_attn_fwd_f32.argtypes = [_VOID] * 5 + [_INT] * 5 + [_FLOAT, _INT, _VOID]
    lib.dpwa_flash_attn_fwd_f32.restype = _INT
    lib.dpwa_flash_attn_bwd_f32.argtypes = [_VOID] * 10 + [_INT] * 5 + [_FLOAT, _INT, _VOID]
    lib.dpwa_flash_attn_bwd_f32.restype = _INT
    # (q, k, v, [do, lse, di,] outputs; B, sp, t_local, H, KV, D; scale;
    # hop, rows, q_off, k_off; the case word; the stream)
    ring = [_INT] * 6 + [_FLOAT] + [_INT] * 4 + [ctypes.c_ulonglong, _VOID]
    lib.dpwa_ring_hop_fwd_f32.argtypes = [_VOID] * 5 + ring
    lib.dpwa_ring_hop_fwd_f32.restype = _INT
    lib.dpwa_ring_hop_bwd_f32.argtypes = [_VOID] * 9 + ring
    lib.dpwa_ring_hop_bwd_f32.restype = _INT
    lib.dpwa_flash_error_string.argtypes = [_INT]
    lib.dpwa_flash_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = lib.dpwa_flash_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def _qkv_fault(q, k, v) -> tuple[type, str] | None:
    """Why the kernels cannot take q ``[B, T, H, D]`` and k, v ``[B, T,
    KV, D]``, as (exception type, message), or None when they can."""
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != torch.float32:
            return TypeError, f"{what} must be float32, got {t.dtype}"
        if t.dim() != 4 or t.device != q.device:
            return ValueError, f"{what} must be [B, T, heads, D] on {q.device}"
    b, t, h, d = q.shape
    kv = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (b, t) or k.shape[3] != d:
        return ValueError, (
            f"k and v must be [{b}, {t}, KV, {d}], got {tuple(k.shape)} and {tuple(v.shape)}"
        )
    if d not in HEAD_DIMS:
        return ValueError, f"head dim {d} is not one of {HEAD_DIMS}"
    if t % T_MULTIPLE:
        return ValueError, f"T = {t} is not a multiple of {T_MULTIPLE}"
    if kv < 1 or h % kv:
        return ValueError, f"{h} query heads are not a multiple of {kv} kv heads"
    if b * h > _MAX_GRID_Y:
        return ValueError, f"B·H = {b * h} exceeds {_MAX_GRID_Y}"
    return None


def flash_supported(q, k, v) -> bool:
    """Whether B5 takes these inputs: float32 q, k and v, D in
    :data:`HEAD_DIMS`, T a multiple of :data:`T_MULTIPLE`, KV dividing H
    and B·H within the grid.  Exactly what :func:`_check_qkv` accepts."""
    return _qkv_fault(q, k, v) is None


def _check_qkv(q, k, v, name: str) -> tuple[int, int, int, int, int]:
    """Shapes of q ``[B, T, H, D]`` and k, v ``[B, T, KV, D]`` as the
    kernels take them; raises on anything else."""
    fault = _qkv_fault(q, k, v)
    if fault is not None:
        exc, msg = fault
        raise exc(f"{name}: {msg}")
    b, t, h, d = q.shape
    return b, t, h, k.shape[2], d


def flash_attn_fwd(q, k, v, *, causal: bool):
    """B5 forward: ``(o [B, T, H, D], lse [B, H, T])`` in float32 for q
    ``[B, T, H, D]`` and k, v ``[B, T, KV, D]`` (KV dividing H), D 128
    and T a multiple of 128 on the card."""
    if q.device.type == "cpu":
        return torch_flash_attn_fwd(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd: unsupported device {q.device}")
    b, t, h, kv, d = _check_qkv(q, k, v, "flash_attn_fwd")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.dpwa_flash_attn_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, t, h, kv, d, 1.0 / math.sqrt(d), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check_launch(lib, "flash_attn_fwd", err)
    flash_attn_fwd.launches += 1
    return o, lse


def flash_attn_bwd(q, k, v, o, lse, do, *, causal: bool):
    """B5 backward: ``(dq, dk, dv)`` shaped like ``q, k, v``, from the
    forward's ``o`` and ``lse`` and the output gradient ``do``."""
    if q.device.type == "cpu":
        return torch_flash_attn_bwd(q, k, v, o, lse, do, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_bwd: unsupported device {q.device}")
    b, t, h, kv, d = _check_qkv(q, k, v, "flash_attn_bwd")
    for tensor, what in ((o, "o"), (do, "do")):
        if tensor.shape != q.shape or tensor.dtype != torch.float32 or tensor.device != q.device:
            raise ValueError(f"flash_attn_bwd: {what} must be float32 like q")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_attn_bwd: lse must be float32 [{b}, {h}, {t}]")
    q, k, v, o, lse, do = (x.contiguous() for x in (q, k, v, o, lse, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.dpwa_flash_attn_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, t, h, kv, d, 1.0 / math.sqrt(d), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check_launch(lib, "flash_attn_bwd", err)
    flash_attn_bwd.launches += 1
    return dq, dk, dv


flash_attn_fwd.launches = 0
flash_attn_bwd.launches = 0


def reset_launch_counts() -> None:
    """Set both wrappers' ``launches`` counts to 0."""
    flash_attn_fwd.launches = 0
    flash_attn_bwd.launches = 0


def _fold(t: torch.Tensor, dim, n: int) -> torch.Tensor:
    """A vmapped ``[.., n, ..]`` tensor with its mapped axis ``dim`` folded
    into the leading (batch) axis; an unmapped one (``dim`` None) is
    broadcast over the ``n`` first."""
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:])


class FlashAttention(torch.autograd.Function):
    """``(o, lse) = FlashAttention.apply(q, k, v, causal)`` through B5,
    differentiable in q, k and v (``lse`` is not)."""

    @staticmethod
    def forward(q, k, v, causal):
        return flash_attn_fwd(q, k, v, causal=causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBackward.apply(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal):
        n = info.batch_size
        q, k, v = (_fold(t, d, n) for t, d in zip((q, k, v), in_dims[:3]))
        o, lse = FlashAttention.apply(q, k, v, causal)
        return (o.unflatten(0, (n, -1)), lse.unflatten(0, (n, -1))), (0, 0)


class FlashAttentionBackward(torch.autograd.Function):
    """The backward kernels as a function of their inputs, so that the
    backward of :class:`FlashAttention` also batches under ``vmap``."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal):
        return flash_attn_bwd(q, k, v, o, lse, do, causal=causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal):
        n = info.batch_size
        args = [_fold(t, d, n) for t, d in zip((q, k, v, o, lse, do), in_dims[:6])]
        grads = FlashAttentionBackward.apply(*args, causal)
        return tuple(g.unflatten(0, (n, -1)) for g in grads), (0, 0, 0)


def flash_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """Attention output ``[B, T, H, D]`` through B5 (the plain version on
    CPU tensors), differentiable and batchable with ``torch.func``."""
    return FlashAttention.apply(q, k, v, causal)[0]
