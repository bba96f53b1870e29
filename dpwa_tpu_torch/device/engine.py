"""The merge of the TCP transport (the port of
:class:`dpwa_tpu.device.engine.MergeEngine`'s families).

Every merge is out of place over the row the frame covers, the local
replica as ``x``, and its output is adopted by the caller
(``DeviceReplica.swap``).  On the CPU the same calls run the kernels' plain
versions, which is the host path of ``TcpTransport.exchange``.

- dense and bf16 (:func:`merge` of a tensor): one launch of B2
  (:func:`~dpwa_tpu_torch.ops.merge.gather_merge`) over ``[1, d]``, the
  landed frame as the wire buffer ``w`` (a bf16 frame widened in the
  kernel);
- int8 (:func:`merge_int8`): B2's int8-frame form
  (:func:`~dpwa_tpu_torch.ops.merge.int8_frame_merge`) from the landed
  frame's codes and scales, so the dense frame is never written;
- top-k (:func:`merge_topk`): one launch of B2's top-k form
  (:func:`~dpwa_tpu_torch.ops.merge.topk_merge`), which writes B2's
  self-lerp of the row (``y = x``) and the k shipped coordinates in one
  pass.  Off the support the reference merges its densified estimate,
  which equals ``x`` there, so the self-lerp is the reference's value (not
  ``x``).  On the support it is the reference's host merge (``exchange``,
  ``native.merge_out``), ``fma(1-α, x, α·v)``.  The reference's device
  engine's scatter (``build_topk``) is XLA's choice of product to fuse,
  which on some hosts is the other one and then differs in the last bit at
  α ≠ 0.5; the port follows ``exchange``;
- shard (:func:`merge_shard`, :func:`merge_shard_int8`): B2's dense or
  int8-frame form over the slice ``[lo, hi)`` of a copy of the row, so the
  other k−1 slices reach the output bit-identical; a top-k inner
  (:func:`merge_shard_topk`) is one launch of the top-k form over the
  slice, which copies the other slices itself;
- fold (:func:`fold`): a run of k landed float32 frames (an int8 frame
  dequantised) merged in arrival order by one launch of B2's fold form
  (:func:`~dpwa_tpu_torch.ops.merge.fold_merge`), bit-equal to k
  :func:`merge_dense` calls one after the other.  :func:`stats` counts the
  fold launches and the frames they merged, as the reference's engine
  counts ``fold_frames``.

The arithmetic is the reference's TCP merge: ``native.merge_out``'s
``(1-α)·x + α·y`` as g++ contracts it and the device engine's XLA lerp, one
fused multiply-add of the local product, ``fma(1-α, x, α·y)``
(``tests/test_torch_tcp.py`` pins it at α ≠ 0.5 against both); the int8
frame's ``y`` is ``q · scale`` rounded on its own, as the reference's decode
rounds it.  That is B2's int8-wire form; a bf16 frame takes its bf16 form,
whose rounding of ``y`` to bf16 is exact on a bf16 frame.  B2's launch
counts (``gather_merge.launches``, ``int8_frame_merge.launches`` and
``topk_merge.launches``) count the merges, one a merge; :func:`stats`
counts the top-k merges (whole-row and shard) on every device.
"""

from __future__ import annotations

import threading
from typing import Sequence, Union

import torch

from dpwa_tpu_torch.ops.merge import fold_merge, gather_merge, int8_frame_merge, topk_merge
from dpwa_tpu_torch.ops.quantize import Int8Payload, TopkPayload
from dpwa_tpu_torch.ops.shard import ShardPayload

# B2's forms (ops.merge.WIRES) that compute the reference's TCP merge.
F32_FORM = "int8"  # fma(1-α, x, α·y) on a float32 frame
BF16_FORM = "bf16"  # the same on a bf16 frame

Remote = Union[torch.Tensor, Int8Payload, TopkPayload, ShardPayload]


def _b2(x: torch.Tensor, alpha: float, w=None, out=None) -> torch.Tensor:
    """B2 over the row ``x`` (``[d]``): with the landed frame ``w``, or
    with ``x`` itself (the self-lerp); into ``out`` when given."""
    a = torch.full((1,), alpha, dtype=torch.float32, device=x.device)
    partner = torch.zeros(1, dtype=torch.int32, device=x.device)
    form = BF16_FORM if w is not None and w.dtype == torch.bfloat16 else F32_FORM
    res = gather_merge(x[None], partner, a, wire=form, w=None if w is None else w[None],
                       out=None if out is None else out[None], lerp_self=w is None)
    return res[0]


def _check_row(local: torch.Tensor, n: int, device) -> None:
    if local.numel() != n or local.device != device:
        raise ValueError(
            f"frame of {n} on {device} does not match the replica "
            f"{tuple(local.shape)} on {local.device}"
        )


def merge_dense(local: torch.Tensor, remote: torch.Tensor, alpha: float,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """``(1-α)·local + α·remote`` (a landed float32 or bf16 frame of the
    same length and device) as a new flat float32 tensor (or into ``out``)."""
    _check_row(local, remote.numel(), remote.device)
    return _b2(local, alpha, w=remote, out=out)


def merge_int8(local: torch.Tensor, payload: Int8Payload, alpha: float,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """A landed int8-chunked frame: B2's int8-frame form from its codes and
    scales."""
    scales, q = payload.views()
    _check_row(local, payload.n, q.device)
    return int8_frame_merge(local, q, scales, alpha, out=out)


def _topk(local: torch.Tensor, payload: TopkPayload, alpha: float, lo: int = 0,
          hi: int | None = None) -> torch.Tensor:
    idx = payload.indices
    if idx.device.type == "cuda":
        idx = idx.to(torch.int32)
    with _STATS_LOCK:
        _STATS["topk_merges"] += 1
    return topk_merge(local, idx, payload.values, alpha, lo, hi)


def merge_topk(local: torch.Tensor, payload: TopkPayload, alpha: float) -> torch.Tensor:
    """A landed top-k frame: the self-lerp of the row and its support, one
    launch."""
    _check_row(local, payload.n, payload.values.device)
    return _topk(local, payload, alpha)


def _bounds(local: torch.Tensor, payload: ShardPayload) -> tuple:
    if local.numel() != payload.d:
        raise ValueError(f"shard frame of d={payload.d} does not match the replica {local.numel()}")
    return payload.bounds


def _sliced(local: torch.Tensor, payload: ShardPayload):
    lo, hi = _bounds(local, payload)
    out = local.clone()  # the k−1 unshipped slices, bit-identical
    return local[lo:hi], out, out[lo:hi]


def merge_shard(local: torch.Tensor, payload: ShardPayload, alpha: float) -> torch.Tensor:
    """A landed shard frame with a dense inner (float32 or bf16): B2 over
    the slice only."""
    x, out, dst = _sliced(local, payload)
    merge_dense(x, payload.dense_inner(), alpha, out=dst)
    return out


def merge_shard_int8(local: torch.Tensor, payload: ShardPayload, alpha: float) -> torch.Tensor:
    """A landed shard frame with an int8-chunked inner (its scale table
    restarts at the slice): B2's int8-frame form over the slice."""
    x, out, dst = _sliced(local, payload)
    merge_int8(x, payload.inner, alpha, out=dst)
    return out


def merge_shard_topk(local: torch.Tensor, payload: ShardPayload, alpha: float) -> torch.Tensor:
    """A landed shard frame with a top-k inner (indices into the slice):
    the copy of the other slices, the self-lerp of the slice and its
    support, one launch."""
    lo, hi = _bounds(local, payload)
    return _topk(local, payload.inner, alpha, lo, hi)


def merge(local: torch.Tensor, remote: Remote, alpha: float) -> torch.Tensor:
    """Merge a landed frame by its type: a float32 or bf16 tensor, or a
    codec payload (on ``local``'s device)."""
    if isinstance(remote, Int8Payload):
        return merge_int8(local, remote, alpha)
    if isinstance(remote, TopkPayload):
        return merge_topk(local, remote, alpha)
    if isinstance(remote, ShardPayload):
        if isinstance(remote.inner, TopkPayload):
            return merge_shard_topk(local, remote, alpha)
        if isinstance(remote.inner, Int8Payload):
            return merge_shard_int8(local, remote, alpha)
        return merge_shard(local, remote, alpha)
    return merge_dense(local, remote, alpha)


_STATS_LOCK = threading.Lock()
_STATS = {"fold_dispatches": 0, "fold_frames": 0, "topk_merges": 0}


def fold(local: torch.Tensor, remotes: Sequence[torch.Tensor], alphas: Sequence[float]) -> torch.Tensor:
    """Batched multi-peer fold: ``local`` merged with the landed float32
    frames ``remotes`` (each the replica's length, on its device) at
    ``alphas`` in order, by one launch of B2's fold form, as a new flat
    tensor; ``local`` itself for no frames.  Raises on a length mismatch."""
    if len(remotes) != len(alphas):
        raise ValueError(f"fold got {len(remotes)} frames but {len(alphas)} alphas")
    if not remotes:
        return local
    for r in remotes:
        _check_row(local, r.numel(), r.device)
    with _STATS_LOCK:
        _STATS["fold_dispatches"] += 1
        _STATS["fold_frames"] += len(remotes)
    return fold_merge(local, [r.reshape(-1) for r in remotes], alphas)


def stats() -> dict:
    """The fold launches and the frames they merged, and the top-k merges
    (one :func:`~dpwa_tpu_torch.ops.merge.topk_merge` each), process-wide."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_stats() -> None:
    with _STATS_LOCK:
        for key in _STATS:
            _STATS[key] = 0
