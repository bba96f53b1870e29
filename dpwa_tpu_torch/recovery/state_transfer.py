"""Pickle-free train-state serialization for the STATE wire (the port of
:mod:`dpwa_tpu.recovery.state_transfer`).

A bootstrap payload is one self-describing blob::

    magic(4s="DPST") | u32 header_len | header JSON (utf-8) | raw buffers

The compact JSON header is ``{"version", "meta", "arrays",
"payload_crc32"}`` in that order, ``arrays`` one ``{"dtype", "shape"}``
per leaf and ``meta`` the caller's JSON metadata (clock, step, loss, ...);
the buffers are the leaves' little-endian bytes, concatenated in leaf
order.  For the same leaves and meta the blob is the reference's byte for
byte, so either package bootstraps from the other's donor.

Leaves are numpy arrays, torch tensors (read back to the host) or Python
and numpy scalars.  A tree is a flat list or tuple of leaves, or a
``{name: leaf}`` dict (nested dicts allowed), flattened with its keys
sorted, the order ``jax.tree_util`` gives a dict.  Unpacking is
template-driven: the rejoiner passes its own init as ``like``, so only
leaf buffers ride the wire, each checked against the template's shape;
``like=None`` returns the flat list of numpy leaves.
"""

from __future__ import annotations

import json
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from dpwa_tpu_torch.parallel import protocol_constants as pc

_MAX_HEADER = 1 << 24  # 16 MiB of JSON metadata is already absurd


def _leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the reference's order: a list or tuple in
    order, a dict by sorted key, recursively."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with ``leaves`` in its leaf order; a torch leaf
    of the template becomes a CPU tensor, any other a numpy array."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        leaf = next(it)
        return torch.from_numpy(leaf) if isinstance(node, torch.Tensor) else leaf

    return build(like)


def _as_array(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("pack_state: a bf16 tensor has no numpy dtype; widen it first")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def pack_state(tree: Any, meta: Optional[dict] = None) -> bytes:
    """Serialize a tree of arrays and JSON metadata into one blob (one copy
    of the leaves' bytes; the CRC is taken over them in place)."""
    arrays, buffers = [], []
    crc = 0
    for leaf in _leaves(tree):
        arr = _as_array(leaf)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        # The shape before ascontiguousarray, which makes a 0-d array 1-d.
        shape = list(arr.shape)
        arr = np.ascontiguousarray(arr)
        arrays.append({"dtype": arr.dtype.str, "shape": shape})
        buf = memoryview(arr.reshape(-1).view(np.uint8))
        crc = zlib.crc32(buf, crc)
        buffers.append(buf)
    header = {"version": 1, "meta": meta or {}, "arrays": arrays, "payload_crc32": crc}
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return b"".join([pc.STATE_PACK_MAGIC, pc.STATE_PACK_LEN.pack(len(hdr)), hdr, *buffers])


def unpack_state(blob, like: Any = None) -> Tuple[Any, dict]:
    """Parse a :func:`pack_state` blob: ``(state, meta)``.

    With ``like`` (a template tree from the caller's own init) the leaves
    are checked against the template's shapes and put in its structure;
    without it ``state`` is the flat list of numpy leaves (copies).  Raises
    :class:`ValueError` on any structural violation, as the reference's:
    the bootstrap then takes that donor as unusable."""
    view = memoryview(blob)
    magic = pc.STATE_PACK_MAGIC
    if len(view) < len(magic) + pc.STATE_PACK_LEN.size:
        raise ValueError("state blob too short for header")
    if bytes(view[: len(magic)]) != magic:
        raise ValueError("bad state blob magic")
    off = len(magic)
    (hdr_len,) = pc.STATE_PACK_LEN.unpack_from(view, off)
    off += pc.STATE_PACK_LEN.size
    if hdr_len > _MAX_HEADER or off + hdr_len > len(view):
        raise ValueError("state blob header length out of range")
    try:
        header = json.loads(bytes(view[off : off + hdr_len]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"state blob header is not JSON: {e}") from None
    off += hdr_len
    if header.get("version") != 1:
        raise ValueError(f"unknown state blob version {header.get('version')}")
    payload = view[off:]
    if zlib.crc32(payload) != header.get("payload_crc32"):
        raise ValueError("state blob payload CRC mismatch")
    leaves = []
    pos = 0
    for spec in header.get("arrays", []):
        dtype = np.dtype(spec["dtype"])
        shape = tuple(int(s) for s in spec["shape"])
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        if pos + nbytes > len(payload):
            raise ValueError("state blob payload truncated")
        count = nbytes // dtype.itemsize
        leaves.append(
            np.frombuffer(payload, dtype=dtype, count=count, offset=pos).reshape(shape).copy()
        )
        pos += nbytes
    if pos != len(payload):
        raise ValueError("state blob payload has trailing bytes")
    meta = header.get("meta", {})
    if like is None:
        return leaves, meta
    template = _leaves(like)
    if len(template) != len(leaves):
        raise ValueError(f"state blob has {len(leaves)} leaves, template has {len(template)}")
    for i, (got, want) in enumerate(zip(leaves, template)):
        want_shape = tuple(want.shape) if isinstance(want, torch.Tensor) else tuple(np.shape(want))
        if got.shape != want_shape:
            raise ValueError(f"state blob leaf {i} shape {got.shape} != template {want_shape}")
    return _unflatten(like, leaves), meta
