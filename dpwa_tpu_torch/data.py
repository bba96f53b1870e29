"""Per-peer data streams (the port of :mod:`dpwa_tpu.data`).

Each peer trains on its own stream: :func:`peer_batches` deals every peer a
disjoint shard of one dataset and an independent shuffle, and yields
peer-stacked ``[n_peers, batch, ...]`` numpy arrays — the same arrays, from
the same seed, as the reference.  :func:`device_batches` stages them on the
device ahead of use.
"""

from __future__ import annotations

import collections
from typing import Iterator, Tuple

import numpy as np
import torch

Array = np.ndarray


def peer_split(
    x: Array, y: Array, n_peers: int, seed: int = 0
) -> Tuple[list, list]:
    """Deal the dataset into n disjoint per-peer shards (own data streams)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(x))
    shard = len(x) // n_peers
    xs = [x[order[i * shard : (i + 1) * shard]] for i in range(n_peers)]
    ys = [y[order[i * shard : (i + 1) * shard]] for i in range(n_peers)]
    return xs, ys


class PeerBatchStream:
    """Endless stream of peer-stacked batches ``([n, b, ...], [n, b])``.

    Each peer cycles its own shard with an independent shuffle.  The stream
    is checkpointable: :meth:`state_dict` captures every peer's RNG state
    and epoch cursor (JSON-serializable) and :meth:`load_state_dict`
    restores them, so a resumed run reproduces the batch sequence."""

    def __init__(
        self,
        x: Array,
        y: Array,
        n_peers: int,
        batch_size: int,
        seed: int = 0,
    ):
        self.n_peers = n_peers
        self.batch_size = batch_size
        self.xs, self.ys = peer_split(x, y, n_peers, seed)
        self._rngs = [
            np.random.default_rng(seed + 1000 + i) for i in range(n_peers)
        ]
        self._cursors = [np.array([], dtype=np.int64)] * n_peers
        self.batch_count = 0

    def __iter__(self) -> "PeerBatchStream":
        return self

    def __next__(self) -> Tuple[Array, Array]:
        bx, by = [], []
        for i in range(self.n_peers):
            while len(self._cursors[i]) < self.batch_size:
                self._cursors[i] = np.concatenate(
                    [self._cursors[i], self._rngs[i].permutation(len(self.xs[i]))]
                )
            take, self._cursors[i] = (
                self._cursors[i][: self.batch_size],
                self._cursors[i][self.batch_size :],
            )
            bx.append(self.xs[i][take])
            by.append(self.ys[i][take])
        self.batch_count += 1
        return np.stack(bx), np.stack(by)

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of the stream position."""
        return {
            "n_peers": self.n_peers,
            "batch_size": self.batch_size,
            "batch_count": self.batch_count,
            "cursors": [c.tolist() for c in self._cursors],
            "rng_states": [r.bit_generator.state for r in self._rngs],
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot; raises on a peer-count or
        batch-size mismatch, which would replay a different sequence."""
        for field, mine in (
            ("n_peers", self.n_peers),
            ("batch_size", self.batch_size),
        ):
            if field in state and int(state[field]) != mine:
                raise ValueError(
                    f"stream state was saved with {field}="
                    f"{int(state[field])}, this stream has {field}={mine}"
                )
        if (
            len(state["cursors"]) != self.n_peers
            or len(state["rng_states"]) != self.n_peers
        ):
            raise ValueError(
                f"stream state covers {len(state['cursors'])} peers "
                f"({len(state['rng_states'])} rng states), this stream "
                f"has {self.n_peers}"
            )
        self.batch_count = int(state["batch_count"])
        self._cursors = [
            np.asarray(c, dtype=np.int64) for c in state["cursors"]
        ]
        for r, s in zip(self._rngs, state["rng_states"]):
            r.bit_generator.state = s


def peer_batches(
    x: Array,
    y: Array,
    n_peers: int,
    batch_size: int,
    seed: int = 0,
) -> PeerBatchStream:
    """Build a :class:`PeerBatchStream`."""
    return PeerBatchStream(x, y, n_peers, batch_size, seed)


def device_batches(
    batches: Iterator[Tuple[Array, ...]], device, size: int = 2
) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Stage host batches onto ``device`` ahead of use.

    On a CUDA device each array is copied into pinned host memory and sent
    with a ``non_blocking`` copy, keeping ``size`` batches in flight so the
    copy of batch k+1 overlaps the step on batch k.  On the CPU the arrays
    are wrapped as tensors."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def put(item):
        tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in item)
        if cuda:
            tensors = tuple(
                t.pin_memory().to(device, non_blocking=True) for t in tensors
            )
        return tensors

    buf: collections.deque = collections.deque()
    for item in batches:
        buf.append(put(item))
        if len(buf) >= max(1, size):
            yield buf.popleft()
    while buf:
        yield buf.popleft()
