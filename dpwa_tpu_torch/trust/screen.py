"""Payload statistics and robust (median/MAD) baselines for trust screening
(the port of :mod:`dpwa_tpu.trust.screen`).

The sensing half of the content-trust plane (the policy is
:mod:`dpwa_tpu_torch.trust.manager`).  For each fetched REMOTE payload it
computes, against the local replica, where both lie (the card by default):

- ``norm_ratio``: ``‖remote‖ / ‖local‖`` (a scale attack moves it);
- ``update_ratio``: ``‖remote − local‖ / ‖local‖`` (the merge step the
  payload implies);
- ``cosine``: direction agreement (a sign-flip lands at −1);
- ``leaf_ratio``: the max over leaves of ``max|remote_leaf| /
  max|local_leaf|`` (a poisoned leaf hides inside a global norm).  Leaf
  boundaries come from the adapter's model (``TcpTransport.set_trust_leaves``
  with :func:`~dpwa_tpu_torch.utils.pytree.leaf_sizes`, in the frame's
  order), else fixed ``SEGMENT``-element segments.

:func:`payload_sums` is one pass of plain torch reductions over the two
vectors on their device, with no readback: the four float32 sums and the
per-leaf max-abs ratio as five float32 scalars, so the caller can read
them back together with the guard's (one sync for both).  The reference
sums in one XLA program, in another order: ``norm_ratio`` and
``update_ratio`` agree within a relative 1e-5 and ``cosine`` within an
absolute 1e-5 (``tests/test_torch_trust_screen.py`` states what it measured).
``leaf_ratio`` is maxima and one float32 division, ``ra / (la + 1e-12)``,
so it is the reference's bit for bit.  A top-k frame is screened on its
support (:func:`payload_stats_sparse`).

:class:`RobustBaseline` is the reference's median/MAD window, as it is.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional, Sequence

import numpy as np
import torch

_EPS = 1e-12
# Per-segment granularity when no leaf map is known.
SEGMENT = 4096
# Stats the baseline screens (order is stable: it rides into the events).
BASE_STATS = ("update_ratio", "norm_ratio", "cosine", "leaf_ratio")


_LENGTHS: Dict[tuple, torch.Tensor] = {}


def _lengths(starts: np.ndarray, n: int, device: torch.device) -> torch.Tensor:
    """The segments' lengths on ``device``, made once per (segmentation,
    device): a copy from host memory on every call would wait for the card."""
    key = (starts.tobytes(), n, str(device))
    out = _LENGTHS.get(key)
    if out is None:
        if len(_LENGTHS) >= 8:
            _LENGTHS.clear()
        out = _LENGTHS[key] = torch.as_tensor(np.diff(np.append(starts, n)), device=device)
    return out


def _leaf_max_ratio(
    local: torch.Tensor, remote: torch.Tensor, starts: Optional[np.ndarray]
) -> torch.Tensor:
    """Max over segments of ``max|remote_seg| / max|local_seg|`` as a float32
    scalar on the vectors' device (``np.maximum.reduceat``'s segments)."""
    n = local.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=local.device)
    if starts is None or starts[-1] >= n:
        pad = -n % SEGMENT

        def seg_max(v):
            a = v.abs()
            if pad:
                a = torch.nn.functional.pad(a, (0, pad))
            return a.view(-1, SEGMENT).amax(dim=1)
    else:
        first = int(starts[0])
        lengths = _lengths(starts, n, local.device)

        def seg_max(v):
            # Lengths made here, all positive: unsafe skips the checks that
            # read them back (a sync each).
            return torch.segment_reduce(v[first:].abs(), "max", lengths=lengths, unsafe=True)
    la, ra = seg_max(local), seg_max(remote)
    return (ra / (la + _EPS)).amax()


def payload_sums(
    local: torch.Tensor, remote: torch.Tensor, leaf_starts: Optional[np.ndarray] = None
) -> torch.Tensor:
    """``[‖local‖, ‖remote‖, local·remote, ‖remote−local‖, leaf_ratio]`` as a
    float32 tensor on the vectors' device, not read back.  ``remote`` may be
    bf16 (the bf16 wire): it is judged as float32, as it would merge."""
    a = local.reshape(-1).to(torch.float32)
    b = remote.reshape(-1).to(torch.float32)
    return torch.stack([
        torch.linalg.vector_norm(a),
        torch.linalg.vector_norm(b),
        torch.dot(a, b),
        torch.linalg.vector_norm(b - a),
        _leaf_max_ratio(a, b, leaf_starts),
    ])


def stats_from_sums(sums: Sequence[float]) -> Dict[str, float]:
    """The screening statistics from :func:`payload_sums`' five values (host
    floats), as the reference forms them."""
    nl, nr, dot, upd, leaf = (float(x) for x in sums)
    return {
        "local_norm": nl,
        "remote_norm": nr,
        "cosine": dot / max(nl * nr, _EPS),
        "norm_ratio": nr / max(nl, _EPS),
        "update_ratio": upd / max(nl, _EPS),
        "leaf_ratio": leaf,
    }


def payload_stats(
    local: torch.Tensor, remote: torch.Tensor, leaf_starts: Optional[np.ndarray] = None
) -> Dict[str, float]:
    """Screening statistics of a remote vector against the local one: one
    pass where they lie and one readback."""
    return stats_from_sums(payload_sums(local, remote, leaf_starts).tolist())


def payload_sums_sparse(local: torch.Tensor, indices: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """:func:`payload_sums` of a top-k frame's support: the shipped values
    against the same coordinates of the local replica (leaf segments
    uniform), not read back."""
    return payload_sums(local.reshape(-1)[indices.to(torch.int64)], values)


def payload_stats_sparse(local: torch.Tensor, indices: torch.Tensor,
                         values: torch.Tensor) -> Dict[str, float]:
    """Screening statistics of a SPARSE (top-k) payload on its support.  Off
    the support the densified vector is the local replica, so full-vector
    statistics would sit near 1 whatever the k values hold; on the support a
    sign-flip lands at cosine −1 and a scale attack above the norm bound."""
    return stats_from_sums(payload_sums_sparse(local, indices, values).tolist())


def leaf_starts_from_sizes(sizes: Sequence[int], total: int) -> Optional[np.ndarray]:
    """Segment start offsets for a model's leaf sizes (None when the sizes
    don't tile ``total``, so the caller falls back to uniform segments)."""
    sizes = [int(s) for s in sizes if int(s) > 0]
    if not sizes or sum(sizes) != total:
        return None
    return np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.intp)


class RobustBaseline:
    """Median/MAD window over one statistic's accepted history."""

    def __init__(self, window: int):
        self._window: Deque[float] = deque(maxlen=max(2, int(window)))

    def __len__(self) -> int:
        return len(self._window)

    def push(self, x: float) -> None:
        self._window.append(float(x))

    def zscore(self, x: float) -> float:
        """Robust |z| of ``x`` against the window (0 when empty)."""
        if not self._window:
            return 0.0
        arr = np.asarray(self._window, dtype=np.float64)
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med)))
        # 1.4826·MAD ≈ σ under normality; the relative floor keeps a
        # degenerate (constant) window from making any deviation infinite.
        denom = max(1.4826 * mad, 0.05 * max(1.0, abs(med)), _EPS)
        return abs(float(x) - med) / denom

    def snapshot(self) -> Dict[str, float]:
        if not self._window:
            return {"n": 0}
        arr = np.asarray(self._window, dtype=np.float64)
        med = float(np.median(arr))
        return {
            "n": len(arr),
            "median": round(med, 6),
            "mad": round(float(np.median(np.abs(arr - med))), 6),
        }
