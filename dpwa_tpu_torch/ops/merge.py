"""Pairwise-average merge ops: ``x_i ← (1−α_i)·x_i + α_i·y_{partner(i)}``.

The port of :mod:`dpwa_tpu.ops.merge`.  Two kernels, hand-written in CUDA
for Hopper (``csrc/merge.cu``), each beside its plain PyTorch version:

- :func:`pair_merge_` (B1, replaces ``pallas_pair_merge``) merges both rows
  of every pair of an involution in place: one read and one write per
  element, the floor for any merge.  The stacked train step's pairwise
  exchange is one launch of it.
- :func:`gather_merge` (B2, replaces ``pallas_pairwise_merge``) is the
  out-of-place gather form, for pull maps that are not involutions.  The
  TCP transport's codec frames take two more forms of it over one row:
  :func:`int8_frame_merge` (the partner's value dequantised from a landed
  int8-chunked frame in registers) and :func:`topk_merge` (a top-k
  frame's whole merge in one pass: the self-lerp of the row or of a shard
  frame's slice, the copy of the rest, and the support), and the fan-in
  rounds' runs of dense frames take its fold form (:func:`fold_merge`: k
  landed rows merged in one pass, in order).  :func:`support_merge_` (the
  support alone, over B2's self-lerp) is the two-launch route
  :func:`topk_merge` replaced, which no path launches; it stays to be
  timed against it.

``y`` is the partner's row as it arrived over the wire: ``x`` itself, or
in the wire form a second buffer ``w`` laid out like ``x`` — the int8
wire's dequantized rows (:func:`dpwa_tpu_torch.ops.quantize.
fake_quant_rows`).

A wrapper takes its plain version only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises; nothing falls back.  Each launch
adds one to the wrapper's ``launches`` count.

Arithmetic: every form computes one fused multiply-add in float32, as
XLA's CPU backend does for the reference's ``(1−α)·x + α·y``, and which
product it fuses depends on the wire (:data:`WIRES`):
``fma(α, y, (1−α)·x)`` on the f32 wire, ``fma(1−α, x, α·bf16(y))`` on the
bf16 wire and ``fma(1−α, x, α·y)`` on the int8 wire, ``y`` there the
dequantized row.  ``torch.addcmul`` on the CPU gives the same bits.  A form
with two roundings, or the other product fused, misses the reference's last
bit on a large share of elements at α = 0.3; at α = 0.5 every form agrees.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y: pairs (B1) or peers (B2)


def involution_pairs(
    partner, *, pad_to: int | None = None, self_pairs: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: (left, right) pair row-lists from an involution.

    Fixed points (``partner[i] == i`` — peers sitting this round out) are
    dropped by default: with the in-place :func:`pair_merge_` an unlisted
    row is simply left untouched.  ``pad_to`` pads the lists to a fixed
    length by repeating fixed-point rows as no-op self-pairs, so every
    entry of a schedule pool can share one shape; padding is only ever
    needed when fixed points exist, so a pad row is always available.

    ``self_pairs=True`` lists each fixed point ``i`` as a pair ``(i, i)``
    after the real pairs instead, for :func:`pair_merge_` with
    ``self_pairs=True`` to merge it with itself at its α of 0, as the
    stacked exchange of the reference does (``1·x + 0·x``: an inf becomes
    NaN).  The lists then cannot be padded.
    """
    p = np.asarray(partner)
    (n,) = p.shape
    if not np.array_equal(p[p], np.arange(n)):
        raise ValueError("partner is not an involution")
    left = np.flatnonzero(np.arange(n) < p)
    right = p[left]
    if self_pairs:
        if pad_to is not None:
            raise ValueError("self_pairs lists cannot be padded")
        fixed = np.flatnonzero(p == np.arange(n))
        left = np.concatenate([left, fixed])
        right = np.concatenate([right, fixed])
    if pad_to is not None:
        if len(left) > pad_to:
            raise ValueError(f"{len(left)} pairs cannot pad to {pad_to}")
        deficit = pad_to - len(left)
        if deficit:
            fixed = np.flatnonzero(p == np.arange(n))
            if fixed.size == 0:
                raise ValueError(
                    "cannot pad a perfect matching: no fixed-point row is "
                    "available for no-op self-pairs"
                )
            pad = np.resize(fixed, deficit)
            left = np.concatenate([left, pad])
            right = np.concatenate([right, pad])
    return left.astype(np.int32), right.astype(np.int32)


WIRES = ("f32", "bf16", "int8")  # the kernels' arithmetic forms, in order


def _form(wire: str, w: torch.Tensor | None, lerp_self: bool = False) -> int:
    if wire not in WIRES:
        raise ValueError(f"unknown wire {wire!r}; expected one of {WIRES}")
    if wire == "int8" and w is None and not lerp_self:
        raise ValueError("the int8 wire merges with the dequantized rows: pass w")
    return WIRES.index(wire)


def _lerp(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor, wire: str) -> torch.Tensor:
    """``(1 − a)·x + a·y`` in the reference's float32 form on ``wire``
    (``addcmul`` is one fused multiply-add on the CPU):
    ``fma(a, y, (1 − a)·x)`` on the f32 wire; ``fma(1 − a, x, a·y)`` on
    the int8 wire; on the bf16 wire the same with ``y`` rounded to nearest
    even bf16 first — what would have arrived over the fabric.  A bf16 ``y``
    (a TCP frame as it landed) is widened exactly first."""
    y = y.to(torch.float32)
    if wire == "f32":
        return torch.addcmul((1.0 - a) * x, a, y)
    if wire == "bf16":
        y = y.to(torch.bfloat16).to(torch.float32)
    return torch.addcmul(a * y, 1.0 - a, x)


def torch_pairwise_merge(
    x: torch.Tensor,
    partner: torch.Tensor,
    alpha: torch.Tensor,
    *,
    wire: str = "f32",
    w: torch.Tensor | None = None,
    lerp_self: bool = False,
) -> torch.Tensor:
    """Plain version of :func:`gather_merge`: out-of-place
    ``(1−α_i)·x_i + α_i·y[partner[i]]`` over ``x`` of shape ``[n, d]``,
    ``y`` = ``w`` if given, else ``x``."""
    _form(wire, w, lerp_self)
    a = alpha.to(torch.float32)[:, None]
    return _lerp(a, x, (x if w is None else w)[partner.long()], wire)


def torch_pair_merge_(
    x: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    alpha: torch.Tensor,
    *,
    wire: str = "f32",
    self_pairs: bool = False,
    w: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of :func:`pair_merge_`: merge rows ``left[k]`` and
    ``right[k]`` of ``x`` (``[n, d]``) in place, both from the pre-merge
    values, each with the other's row of ``w`` (or of ``x``).  Pairs
    ``left[k] == right[k]`` are pads that leave their row bit-identical, or
    with ``self_pairs`` rows merged with themselves.  Returns ``x``."""
    _form(wire, w)
    left, right = left.long(), right.long()
    alpha = alpha.to(torch.float32)
    pad = ((left == right) & (not self_pairs))[:, None]
    a_l, a_r = alpha[left][:, None], alpha[right][:, None]
    x_l, x_r = x[left], x[right]
    y = x if w is None else w
    y_l, y_r = (x_l, x_r) if w is None else (y[left], y[right])
    new_l = torch.where(pad, x_l, _lerp(a_l, x_l, y_r, wire))
    new_r = torch.where(pad, x_r, _lerp(a_r, x_r, y_l, wire))
    x[left] = new_l
    x[right] = new_r
    return x


_VOID = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built and loaded at the first launch."""
    from dpwa_tpu_torch.ops import _build

    lib = _build.load("merge.cu")
    lib.dpwa_pair_merge_f32.argtypes = [
        _VOID, _I64, _I64, _VOID, _I64, _VOID, _VOID, _INT, _VOID, _INT, _INT, _VOID,
    ]
    lib.dpwa_pair_merge_f32.restype = _INT
    lib.dpwa_gather_merge_f32.argtypes = [
        _VOID, _I64, _VOID, _I64, _INT, _VOID, _I64, _I64, _INT, _VOID, _VOID, _INT, _VOID,
    ]
    lib.dpwa_gather_merge_f32.restype = _INT
    lib.dpwa_int8_frame_merge.argtypes = [_VOID, _VOID, _VOID, _VOID, _I64, ctypes.c_float, _VOID]
    lib.dpwa_int8_frame_merge.restype = _INT
    lib.dpwa_support_merge.argtypes = [_VOID, _VOID, _VOID, _VOID, _I64, ctypes.c_float, _VOID]
    lib.dpwa_support_merge.restype = _INT
    lib.dpwa_topk_merge.argtypes = [
        _VOID, _VOID, _VOID, _I64, _VOID, _I64, _I64, _I64, ctypes.c_float, _VOID,
    ]
    lib.dpwa_topk_merge.restype = _INT
    lib.dpwa_fold_merge.argtypes = [_VOID, _VOID, _VOID, _INT, _VOID, _I64, _INT, _VOID]
    lib.dpwa_fold_merge.restype = _INT
    lib.dpwa_cuda_error_string.argtypes = [_INT]
    lib.dpwa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = lib.dpwa_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def _check_rows(x: torch.Tensor, name: str, dtypes=(torch.float32,)) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: x must be {' or '.join(map(str, dtypes))}, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [n, d], got shape {tuple(x.shape)}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{name}: x rows must be contiguous (stride(1) == 1)")
    if x.shape[0] > 1 and x.stride(0) < x.shape[1]:
        raise ValueError(f"{name}: x rows must not overlap (stride(0) >= d)")


def _check_index(t: torch.Tensor, length: int, device, name: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != length:
        raise ValueError(
            f"{name} must be int32[{length}], got {t.dtype}{list(t.shape)}"
        )
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def empty_rows_like(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``[n, d]`` float32 tensor whose rows start at the
    same offset within 16 bytes as ``x``'s and sit a multiple of 32 floats
    apart, so that a kernel reading both moves float4 words whatever ``d``
    is (the caching allocator aligns the base to 512 bytes)."""
    n, d = x.shape
    head = (x.data_ptr() % 16) // 4
    ld = -(-(d + head) // 32) * 32
    buf = torch.empty(n, ld, dtype=x.dtype, device=x.device)
    return buf[:, head:head + d]


def _check_wire_rows(w: torch.Tensor | None, x: torch.Tensor, name: str,
                     bf16: bool = False) -> None:
    """``w`` (if given) must be float32 rows (or, with ``bf16``, bf16 ones
    too) shaped and placed like ``x``'s that share no storage with ``x``."""
    if w is None:
        return
    _check_rows(w, f"{name} w", (torch.float32, torch.bfloat16) if bf16 else (torch.float32,))
    if w.shape != x.shape or w.device != x.device:
        raise ValueError(f"{name}: w must match x's shape and device")
    if w.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        raise ValueError(f"{name}: w must not share x's storage")


def _check_alpha(alpha: torch.Tensor, n: int, device) -> None:
    if alpha.dtype != torch.float32 or tuple(alpha.shape) != (n,):
        raise ValueError(
            f"alpha must be float32[{n}], got {alpha.dtype}{list(alpha.shape)}"
        )
    if alpha.device != device or not alpha.is_contiguous():
        raise ValueError(f"alpha must be contiguous on {device}")


def pair_merge_(
    x: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    alpha: torch.Tensor,
    *,
    wire: str = "f32",
    self_pairs: bool = False,
    w: torch.Tensor | None = None,
) -> torch.Tensor:
    """B1: in-place pair merge over explicit pair lists.

    For pair k with rows ``L = left[k]``, ``R = right[k]``::

        x[L] ← (1−α[L])·x[L] + α[L]·y[R]
        x[R] ← (1−α[R])·x[R] + α[R]·y[L]

    both from the pre-merge values, in float32 in ``wire``'s form
    (:data:`WIRES`; the bf16 wire rounds the partner's value to bf16
    first), ``y`` = ``w`` (the wire form: float32 rows laid out like
    ``x``'s and not sharing its storage; the int8 wire needs it) or else
    ``x``.  Rows in neither list stay bit-identical, and so do pad pairs
    ``L == R`` — unless ``self_pairs``, which merges such a row with its
    own ``y`` row (at α = 0, ``1·x + 0·y``: the stacked exchange's sat-out
    row, where an inf or a NaN in ``y`` becomes NaN).  ``x`` is float32
    ``[n, d]`` with contiguous rows (a column slice of a wider buffer is
    fine); ``left`` and ``right`` are int32, ``alpha`` float32 ``[n]``.
    The lists must name disjoint rows in ``[0, n)`` except for pads: they
    are device data the kernel reads as given, so :func:`involution_pairs`
    (or the transport's pool, built from it) is where they are checked.
    Returns ``x``.
    """
    form = _form(wire, w)
    if x.device.type == "cpu":
        return torch_pair_merge_(
            x, left, right, alpha, wire=wire, self_pairs=self_pairs, w=w
        )
    if x.device.type != "cuda":
        raise ValueError(f"pair_merge_: unsupported device {x.device}")
    _check_rows(x, "pair_merge_")
    _check_wire_rows(w, x, "pair_merge_")
    n, d = x.shape
    k = left.shape[0] if left.dim() == 1 else 0
    _check_index(left, k, x.device, "left")
    _check_index(right, k, x.device, "right")
    _check_alpha(alpha, n, x.device)
    if k > _MAX_GRID_Y:
        raise ValueError(f"pair_merge_: {k} pairs exceed {_MAX_GRID_Y}")
    if k == 0 or d == 0:
        return x
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dpwa_pair_merge_f32(
            x.data_ptr(), x.stride(0), d,
            None if w is None else w.data_ptr(), 0 if w is None else w.stride(0),
            left.data_ptr(), right.data_ptr(), k, alpha.data_ptr(), form,
            int(self_pairs), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check_launch(lib, "pair_merge_", err)
    pair_merge_.launches += 1
    return x


def gather_merge(
    x: torch.Tensor,
    partner: torch.Tensor,
    alpha: torch.Tensor,
    *,
    wire: str = "f32",
    out: torch.Tensor | None = None,
    w: torch.Tensor | None = None,
    lerp_self: bool = False,
) -> torch.Tensor:
    """B2: out-of-place gather merge
    ``out[i] = (1−α_i)·x[i] + α_i·y[partner[i]]`` over float32 ``x``
    ``[n, d]`` (contiguous rows), in ``wire``'s form, ``y`` = ``w`` (the
    wire form, as for :func:`pair_merge_`, whose rows may also hold bf16
    values: a TCP frame as it landed, widened in the kernel) or else ``x``;
    ``partner`` int32
    ``[n]`` with values in ``[0, n)`` (not checked on the card, as for
    :func:`pair_merge_`), ``alpha`` float32 ``[n]``.  ``out`` (float32
    ``[n, d]``, contiguous rows, not overlapping ``x`` or ``w``) is
    allocated when not given, with rows laid out so that the kernel can
    move 16-byte words.  ``lerp_self`` lets the int8 wire's arithmetic run
    with ``y`` = ``x`` (the TCP transport's self-lerp of a row, the value of
    a top-k or sharded merge off the frame's support).  Returns ``out``."""
    form = _form(wire, w, lerp_self)
    if x.device.type == "cpu":
        merged = torch_pairwise_merge(x, partner, alpha, wire=wire, w=w, lerp_self=lerp_self)
        if out is None:
            return merged
        return out.copy_(merged)
    if x.device.type != "cuda":
        raise ValueError(f"gather_merge: unsupported device {x.device}")
    _check_rows(x, "gather_merge")
    _check_wire_rows(w, x, "gather_merge", bf16=True)
    n, d = x.shape
    _check_index(partner, n, x.device, "partner")
    _check_alpha(alpha, n, x.device)
    if n > _MAX_GRID_Y:
        raise ValueError(f"gather_merge: {n} peers exceed {_MAX_GRID_Y}")
    if out is None:
        out = empty_rows_like(x)
    else:
        _check_rows(out, "gather_merge out")
        if out.shape != x.shape or out.device != x.device:
            raise ValueError("gather_merge: out must match x's shape and device")
        for src in (x, w):
            if src is not None and out.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
                raise ValueError("gather_merge: out must not share x's or w's storage")
    if n == 0 or d == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dpwa_gather_merge_f32(
            x.data_ptr(), x.stride(0),
            None if w is None else w.data_ptr(), 0 if w is None else w.stride(0),
            int(w is not None and w.dtype == torch.bfloat16), out.data_ptr(), out.stride(0), d, n, partner.data_ptr(),
            alpha.data_ptr(), form, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check_launch(lib, "gather_merge", err)
    gather_merge.launches += 1
    return out


def _scalar(alpha: float, device) -> torch.Tensor:
    return torch.tensor(float(alpha), dtype=torch.float32, device=device)


def torch_int8_frame_merge(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                           alpha: float) -> torch.Tensor:
    """Plain version of :func:`int8_frame_merge`."""
    from dpwa_tpu_torch.ops.quantize import dequantize_flat

    return _lerp(_scalar(alpha, x.device), x, dequantize_flat(q, scales), "int8")


def torch_support_merge_(out: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
                         values: torch.Tensor, alpha: float) -> torch.Tensor:
    """Plain version of :func:`support_merge_`."""
    idx = idx.long()
    out[idx] = _lerp(_scalar(alpha, x.device), x[idx], values, "int8")
    return out


def _check_flat(t: torch.Tensor, name: str, dtype, device, length: int | None = None) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be a contiguous {dtype} vector on {device}, "
                         f"got {t.dtype}{list(t.shape)} on {t.device}")
    if length is not None and t.numel() != length:
        raise ValueError(f"{name} must hold {length} elements, got {t.numel()}")


def int8_frame_merge(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, alpha: float,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """B2's int8-frame form over one row: ``out = fma(1−α, x, α·y)`` with
    ``y[j] = q[j] · scales[j // 256]``, the partner's replica as a landed
    int8-chunked frame carries it (float32 ``x`` ``[d]``, int8 ``q`` ``[d]``,
    float32 ``scales`` ``[ceil(d / 256)]``).  Bit-equal to B2's int8 form
    on the dequantised frame, without writing it.  Returns ``out`` (a new
    float32 ``[d]`` when not given)."""
    from dpwa_tpu_torch.ops.quantize import n_chunks

    if x.device.type == "cpu":
        merged = torch_int8_frame_merge(x, q, scales, alpha)
        return merged if out is None else out.copy_(merged)
    if x.device.type != "cuda":
        raise ValueError(f"int8_frame_merge: unsupported device {x.device}")
    d = x.numel()
    _check_flat(x, "x", torch.float32, x.device)
    _check_flat(q, "q", torch.int8, x.device, d)
    _check_flat(scales, "scales", torch.float32, x.device, n_chunks(d))
    if out is None:
        out = torch.empty_like(x)
    _check_flat(out, "out", torch.float32, x.device, d)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dpwa_int8_frame_merge(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(), d,
            float(alpha), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check_launch(lib, "int8_frame_merge", err)
    int8_frame_merge.launches += 1
    return out


def support_merge_(out: torch.Tensor, x: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
                   alpha: float) -> torch.Tensor:
    """B2's support form over one row: ``out[idx[j]] = fma(1−α, x[idx[j]],
    α·values[j])`` for unique ``idx`` (int32 on the card) into float32 rows
    ``x`` and ``out`` of one length (not the same tensor), the reference's
    host merge of a densified top-k frame (B2's int8-wire arithmetic).
    Other elements of ``out`` are left as they are (B2's self-lerp of ``x``
    writes them first).  That two-launch route is what :func:`topk_merge`
    replaced; no path launches this form, which stays to be timed against
    it.  Returns ``out``."""
    if x.device.type == "cpu":
        return torch_support_merge_(out, x, idx, values, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"support_merge_: unsupported device {x.device}")
    k = idx.numel()
    _check_flat(x, "x", torch.float32, x.device)
    _check_flat(out, "out", torch.float32, x.device, x.numel())
    _check_flat(idx, "idx", torch.int32, x.device)
    _check_flat(values, "values", torch.float32, x.device, k)
    if out.data_ptr() == x.data_ptr():
        raise ValueError("support_merge_: out must not be x")
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dpwa_support_merge(
            x.data_ptr(), idx.data_ptr(), values.data_ptr(), out.data_ptr(), k,
            float(alpha), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check_launch(lib, "support_merge_", err)
    support_merge_.launches += 1
    return out


def torch_topk_merge(x: torch.Tensor, idx: torch.Tensor, values: torch.Tensor, alpha: float,
                     lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """Plain version of :func:`topk_merge`: a copy of ``x``, B2's self-lerp
    of its slice ``[lo, hi)``, then :func:`torch_support_merge_` there."""
    hi = x.numel() if hi is None else hi
    out = x.clone()
    sl = x[lo:hi]
    out[lo:hi] = _lerp(_scalar(alpha, x.device), sl, sl, "int8")
    torch_support_merge_(out[lo:hi], sl, idx, values, alpha)
    return out


def topk_merge(x: torch.Tensor, idx: torch.Tensor, values: torch.Tensor, alpha: float,
               lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """B2's top-k form: a landed top-k frame's whole merge into a new row, in
    one pass.  ``x`` is the float32 row ``[d]``; the frame covers its slice
    ``[lo, hi)`` (the whole row by default; a shard frame's bounds), and
    ships ``values`` (float32 ``[k]``) at the slice positions ``idx``
    (int32 on the card, sorted and unique, as the frame's decoder checks
    them; not checked again here).  ``out[i] = x[i]`` outside the slice,
    bit for bit; inside it B2's self-lerp ``fma(1−α, x, α·x)``; at ``lo +
    idx[j]`` the reference's host merge ``fma(1−α, x, α·values[j])``.
    Bit-equal to B2's self-lerp of the slice followed by
    :func:`support_merge_`, on a copy of the row for a slice.  Returns the
    new row, laid out in 16 bytes as ``x`` is."""
    hi = x.numel() if hi is None else int(hi)
    lo = int(lo)
    if x.device.type == "cpu":
        return torch_topk_merge(x, idx, values, alpha, lo, hi)
    if x.device.type != "cuda":
        raise ValueError(f"topk_merge: unsupported device {x.device}")
    d, k = x.numel(), idx.numel()
    _check_flat(x, "x", torch.float32, x.device)
    _check_flat(idx, "idx", torch.int32, x.device)
    _check_flat(values, "values", torch.float32, x.device, k)
    if not 0 <= lo <= hi <= d or k > hi - lo:
        raise ValueError(f"topk_merge: {k} entries do not fit the slice [{lo}, {hi}) of {d}")
    out = empty_rows_like(x[None])[0]
    if d == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dpwa_topk_merge(
            x.data_ptr(), idx.data_ptr(), values.data_ptr(), k, out.data_ptr(), d, lo, hi,
            float(alpha), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check_launch(lib, "topk_merge", err)
    topk_merge.launches += 1
    return out


def torch_fold_merge(x: torch.Tensor, rows, alphas) -> torch.Tensor:
    """Plain version of :func:`fold_merge`: the k merges in a row, each B2's
    plain f32-frame form (``fma(1−α, x, α·y)``)."""
    out = x
    for r, a in zip(rows, alphas):
        out = _lerp(_scalar(a, x.device), out, r, "int8")
    return out.clone() if out is x else out


def fold_merge(x: torch.Tensor, rows, alphas, out: torch.Tensor | None = None) -> torch.Tensor:
    """B2's fold form: ``out = x``, then ``out ← fma(1−α_i, out, α_i·r_i)``
    for the float32 rows ``rows[0] … rows[k−1]`` (each ``[d]`` like ``x``)
    and the floats ``alphas`` in order, in one pass; bit-equal to k merges
    of B2's f32-frame form one after the other (``1 − α_i`` in float32, each
    ``α_i·r_i`` rounded on its own).  ``out`` (float32 ``[d]``, sharing no
    storage with ``x`` or a row) is allocated when not given.  Returns
    ``out``."""
    rows, alphas = list(rows), [float(a) for a in alphas]
    if len(rows) != len(alphas):
        raise ValueError(f"fold_merge got {len(rows)} rows but {len(alphas)} alphas")
    if x.device.type == "cpu":
        merged = torch_fold_merge(x, rows, alphas)
        return merged if out is None else out.copy_(merged)
    if x.device.type != "cuda":
        raise ValueError(f"fold_merge: unsupported device {x.device}")
    d = x.numel()
    _check_flat(x, "x", torch.float32, x.device)
    for r in rows:
        _check_flat(r, "a fold row", torch.float32, x.device, d)
    if out is None:
        out = torch.empty_like(x)
    _check_flat(out, "out", torch.float32, x.device, d)
    for src in (x, *rows):
        if out.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
            raise ValueError("fold_merge: out must not share x's or a row's storage")
    if not rows or d == 0:
        return out.copy_(x)
    ptrs = torch.tensor([r.data_ptr() for r in rows], dtype=torch.int64).to(x.device)
    a = torch.tensor(alphas, dtype=torch.float32).to(x.device)
    phase = x.data_ptr() % 16
    vec = all(t.data_ptr() % 16 == phase for t in (out, *rows))
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dpwa_fold_merge(
            x.data_ptr(), ptrs.data_ptr(), a.data_ptr(), len(rows), out.data_ptr(), d,
            int(vec), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check_launch(lib, "fold_merge", err)
    fold_merge.launches += 1
    return out


pair_merge_.launches = 0
gather_merge.launches = 0
int8_frame_merge.launches = 0
support_merge_.launches = 0
topk_merge.launches = 0
fold_merge.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel wrapper's ``launches`` count to 0 (the quantiser's
    too, :func:`dpwa_tpu_torch.ops.quantize.quantize_sr`)."""
    from dpwa_tpu_torch.ops import quantize

    pair_merge_.launches = 0
    gather_merge.launches = 0
    int8_frame_merge.launches = 0
    support_merge_.launches = 0
    topk_merge.launches = 0
    fold_merge.launches = 0
    quantize.quantize_sr.launches = 0


def pairwise_merge(
    x: torch.Tensor,
    partner: torch.Tensor,
    alpha: torch.Tensor,
    *,
    wire: str = "f32",
) -> torch.Tensor:
    """Functional (non-mutating) merge keyed by ``partner``: B2 for a CUDA
    tensor, its plain version for a CPU one.  The in-place form over an
    involution's pair lists is :func:`pair_merge_`."""
    partner = partner.to(device=x.device, dtype=torch.int32).contiguous()
    alpha = alpha.to(device=x.device, dtype=torch.float32).contiguous()
    return gather_merge(x, partner, alpha, wire=wire)
