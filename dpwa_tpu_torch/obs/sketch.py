"""A seeded random-projection sketch of the local replica, made where the
replica lies (the port of :mod:`dpwa_tpu.obs.sketch`).

Every peer piggybacks a ``k``-float sketch of its replica on each served
frame (the ``DPWT`` trailer, :mod:`dpwa_tpu_torch.obs.wire`) and every
fetcher folds the sketches it sees into an online estimate of the ring's
replica disagreement, with no extra round trip.

The sketch is a blocked-Rademacher projection: the flat replica is
zero-padded to ``k·m`` (``m = ceil(n / k)``) and viewed as ``[k, m]``, each
block multiplied by its ±1 signs and summed::

    s_j = sum_i  sign[j, i] * v[j*m + i]

With i.i.d. signs, ``E ||s_a − s_b||² = ||a − b||²`` for any two replicas,
and ``E ||s||² = ||v||²`` (the trailer's ``norm_est``).  The signs are the
reference's ``jax.random.rademacher(_pair_key(seed, 0, 0, 9), (k·m,))``
(control tag 9, :data:`~dpwa_tpu_torch.utils.tags.TAG_SKETCH`) bit for bit,
keyed on the seed only, so every peer of a run projects through the same
signs and sketches from either package compare.

:func:`replica_sketch` runs on the replica's device (the card for a
device-resident replica) and reads back only the ``k`` floats; the reference
reads the whole replica to the host.  The signs are cached on that device
as int8, one ``[k, m]`` matrix (a byte a parameter: 25.6 MB at ResNet-50's
25,557,032, where float32 signs would hold 102.2 MB).  The projection is a
product then a row sum: ±1 times a float32 is exact, so int8 and float32
signs give the same sketch, and on the H100 the two forms took the same
time (0.161 and 0.164 ms at ResNet-50's d), half that of one batched
``[1, m] · [m, 1]`` product over float32 signs (0.308 ms), which reads
each byte once but runs one long dot a block (``chip_smoke.py``'s
obs_exchange phase times the three forms; NVIDIA H100 80GB HBM3, 700 W).  The
values are float32 sums in another order than numpy's, so they equal the
reference's within float32 summation error (bit for bit when every partial
sum is exact, as on a replica of small integers).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

import numpy as np
import torch

from dpwa_tpu_torch.parallel.schedules import _pair_key
from dpwa_tpu_torch.utils import prng
from dpwa_tpu_torch.utils import tags as _tags

SKETCH_TAG = _tags.TAG_SKETCH

# One replica shape per process in practice; the cache is cleared past this
# many (seed, n, k, device) entries.
_SIGN_CACHE_MAX = 4
_sign_lock = threading.Lock()
_sign_cache: Dict[tuple, torch.Tensor] = {}


def sketch_signs(seed: int, n: int, k: int, device=None) -> torch.Tensor:
    """The cached ±1 int8 sign matrix ``[k, ceil(n / k)]`` of (seed, n, k)
    on ``device``."""
    device = torch.device("cpu") if device is None else torch.device(device)
    key = (int(seed), int(n), int(k), str(device))
    with _sign_lock:
        hit = _sign_cache.get(key)
    if hit is not None:
        return hit
    m = -(-int(n) // int(k))
    signs = prng.rademacher(_pair_key(int(seed), 0, 0, SKETCH_TAG), (int(k) * m,),
                            dtype=torch.int8, device=device).view(int(k), m)
    with _sign_lock:
        if len(_sign_cache) >= _SIGN_CACHE_MAX:
            _sign_cache.clear()
        _sign_cache[key] = signs
    return signs


def replica_sketch_tensor(vec: torch.Tensor, seed: int, k: int = 64) -> torch.Tensor:
    """The ``k``-float sketch of the flat float32 ``vec`` as a tensor on
    ``vec``'s device (nothing read back).  The complete blocks are one
    product and row sum over a view of ``vec``; the block the zero padding
    starts in is its own, and blocks of padding only are 0."""
    v = vec.reshape(-1)
    if v.dtype != torch.float32:
        v = v.to(torch.float32)
    n, k = v.numel(), int(k)
    out = torch.zeros(max(k, 0), dtype=torch.float32, device=v.device)
    if n == 0 or k <= 0:
        return out
    signs = sketch_signs(seed, n, k, v.device)
    m = signs.shape[1]
    full, rest = divmod(n, m)
    if full:
        torch.sum(signs[:full] * v[:full * m].view(full, m), dim=1, out=out[:full])
    if rest:
        out[full] = (signs[full, :rest] * v[full * m:]).sum()
    return out


def replica_sketch(vec, seed: int, k: int = 64) -> np.ndarray:
    """Project a flat replica (a tensor on any device, or a host array) to
    ``k`` float32s on the host: computed where the tensor lies, and only the
    ``k`` floats read back."""
    if not isinstance(vec, torch.Tensor):
        vec = torch.from_numpy(np.ascontiguousarray(vec, dtype=np.float32))
    return replica_sketch_tensor(vec, seed, k).cpu().numpy()


class SketchBoard:
    """The online ring-disagreement estimate from piggybacked sketches
    (the reference's class, op for op).  Thread-safe: remote sketches arrive
    on the consuming thread, and ``snapshot()`` is read by the healthz
    thread and the metrics registry."""

    def __init__(self, me: int, k: int = 64):
        self.me = int(me)
        self.k = int(k)
        self._lock = threading.Lock()
        self._local: Optional[np.ndarray] = None
        self._local_seq: Optional[int] = None
        self._remote: Dict[int, dict] = {}  # origin -> {sketch, seq, round}

    def note_local(self, seq: int, sketch: np.ndarray) -> None:
        with self._lock:
            self._local = sketch
            self._local_seq = int(seq)

    def note_remote(self, origin: int, seq: int, sketch: np.ndarray,
                    round: Optional[int] = None) -> None:
        origin = int(origin)
        if origin == self.me or sketch is None:
            return
        with self._lock:
            prev = self._remote.get(origin)
            # seq is a truncated publish clock: keep the newest, but accept
            # a reset (a restarted peer republishes from 0).
            if prev is not None and 0 <= int(seq) < prev["seq"] <= 1 << 20:
                return
            self._remote[origin] = {
                "sketch": sketch,
                "seq": int(seq),
                "round": None if round is None else int(round),
            }

    def disagreement(self) -> tuple:
        """``(rms, rel_rms)`` only, the hot-path slice of :meth:`snapshot`;
        ``(None, None)`` until a local and a remote sketch exist."""
        with self._lock:
            local = self._local
            if local is None or not self._remote:
                return None, None
            tot, n = 0.0, 0
            for info in self._remote.values():
                sk = info["sketch"]
                if sk.shape != local.shape:
                    continue
                dv = local - sk
                tot += float(np.dot(dv, dv))
                n += 1
            if n == 0:
                return None, None
            norm2 = float(np.dot(local, local))
        rms = math.sqrt(tot / n)
        rel = rms / math.sqrt(norm2) if norm2 > 0.0 else None
        return rms, rel

    def snapshot(self) -> dict:
        """The disagreement estimate against every peer seen: ``rms`` over
        peers of the estimated distance, ``rel_rms`` over the local norm
        estimate; None until a local and a remote sketch exist."""
        with self._lock:
            local = self._local
            local_seq = self._local_seq
            remote = {p: dict(info) for p, info in self._remote.items()}
        out: dict = {
            "k": self.k,
            "seq": local_seq,
            "peers_seen": len(remote),
            "rms": None,
            "rel_rms": None,
            "norm_est": None,
            "peers": {},
        }
        if local is None:
            return out
        norm = float(np.linalg.norm(local))
        out["norm_est"] = round(norm, 6)
        if not remote:
            return out
        d2 = []
        for p, info in sorted(remote.items()):
            sk = info["sketch"]
            if sk.shape != local.shape:
                continue
            dist = float(np.linalg.norm(local - sk))
            d2.append(dist * dist)
            out["peers"][str(p)] = {"distance": round(dist, 6), "seq": info["seq"]}
        if not d2:
            return out
        rms = float(np.sqrt(np.mean(d2)))
        out["rms"] = round(rms, 6)
        out["rel_rms"] = round(rms / max(norm, 1e-12), 6)
        return out
