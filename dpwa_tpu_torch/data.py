"""Offline datasets and per-peer data streams (the port of
:mod:`dpwa_tpu.data`).

Each peer trains on its own stream: :func:`peer_batches` deals every peer a
disjoint shard of one dataset and an independent shuffle, and yields
peer-stacked ``[n_peers, batch, ...]`` numpy arrays — the same arrays, from
the same seed, as the reference.  :func:`device_batches` stages them on the
device ahead of use.

The loaders need no network and no scikit-learn: the 8×8 digits that the
reference reads through ``sklearn.datasets.load_digits`` are committed as
``data/digits_fixture/digits.npz`` (its README says where they come from),
and a full MNIST is used where an ``mnist.npz`` lies under one of
:data:`MNIST_ROOTS`.  :func:`gaussian_blobs` is the synthetic task of the
unit tests.  Each returns the reference's arrays bit for bit.
"""

from __future__ import annotations

import collections
import os
from pathlib import Path
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

Array = np.ndarray

REPO = Path(__file__).resolve().parents[1]
DIGITS_NPZ = REPO / "data" / "digits_fixture" / "digits.npz"
# Where :func:`find_mnist_dir` looks: inside the checkout only.
MNIST_ROOTS = (str(REPO / "data" / "mnist"),)


def gaussian_blobs(
    n_classes: int = 4,
    dim: int = 16,
    n_per_class: int = 256,
    seed: int = 0,
    spread: float = 0.5,
) -> Tuple[Array, Array]:
    """Linearly separable-ish classification task for fast tests."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_classes, dim)) * 3.0
    xs, ys = [], []
    for c in range(n_classes):
        xs.append(centers[c] + spread * rng.standard_normal((n_per_class, dim)))
        ys.append(np.full(n_per_class, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    order = rng.permutation(len(x))
    return x[order], y[order]


def load_digits_dataset(
    test_fraction: float = 0.2, seed: int = 0, path: str | os.PathLike = DIGITS_NPZ
) -> Tuple[Array, Array, Array, Array]:
    """The 8×8 grayscale digits (1797 samples) as NHWC float32 in [0, 1]:
    ``(x_train, y_train, x_test, y_test)``, shuffled by ``seed`` and split
    with the first ``test_fraction`` as the test set."""
    with np.load(path) as d:
        images, target = d["images"], d["target"]
    x = (images.astype(np.float32) / 16.0)[..., None]  # [N, 8, 8, 1]
    y = target.astype(np.int32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(x))
    x, y = x[order], y[order]
    n_test = int(len(x) * test_fraction)
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test]


def find_mnist_dir(roots: Sequence[str] = MNIST_ROOTS) -> str | None:
    """The first of ``roots`` that holds an MNIST (``mnist.npz`` or the idx
    files), or None; reads no network."""
    for root in roots:
        if os.path.isdir(root):
            for name in ("mnist.npz", "train-images-idx3-ubyte"):
                if os.path.exists(os.path.join(root, name)):
                    return root
    return None


def load_mnist_or_digits(
    roots: Sequence[str] = MNIST_ROOTS,
) -> Tuple[Array, Array, Array, Array, str]:
    """Full MNIST if an ``mnist.npz`` lies under one of ``roots``, else the
    8×8 digits: ``(x_train, y_train, x_test, y_test, dataset_name)``."""
    root = find_mnist_dir(roots)
    if root is not None:
        npz = os.path.join(root, "mnist.npz")
        if os.path.exists(npz):
            with np.load(npz) as d:
                x_tr = d["x_train"].astype(np.float32)[..., None] / 255.0
                x_te = d["x_test"].astype(np.float32)[..., None] / 255.0
                return (
                    x_tr,
                    d["y_train"].astype(np.int32),
                    x_te,
                    d["y_test"].astype(np.int32),
                    "mnist",
                )
    x_tr, y_tr, x_te, y_te = load_digits_dataset()
    return x_tr, y_tr, x_te, y_te, "digits"


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
