"""Checkpoint and exact resume of the stacked training state (the port of
:mod:`dpwa_tpu.checkpoint`).

The whole :class:`~dpwa_tpu_torch.parallel.stacked.StackedTrainState` —
parameters, optimizer state, model state, per-peer clocks and losses, and
the global schedule position ``step`` — is saved atomically and restored.
Saving ``step`` matters for gossip in particular: the pairing schedule and
the participation draws are functions of it, so a resumed run replays the
same exchanges; with the data stream's sidecar it also replays the same
batches.  Every replica is saved, not one canonical copy: they differ
between exchanges.

The format is the port's own.  A checkpoint ``path`` is a directory:

- ``tensors.pt``: every tensor of the state, on the CPU, in one
  ``torch.save`` of a ``{key: tensor}`` dict (loadable with
  ``weights_only=True``); a :class:`~dpwa_tpu_torch.utils.pytree.FlatParams`
  is one ``[n, P]`` tensor;
- ``manifest.json``, written last, the commit marker: the format, the step,
  each field's structure (the ``FlatParams`` layouts: names, shapes and
  which leaves lead; the optimizer state's records), each tensor's shape
  and dtype, and the tensor file's size and CRC-32.

Beside it, as in the reference: ``<path>-meta.json`` records the state's
class, and ``<path>-data.json`` the data stream's position, stamped with
the step it belongs to (``ckpt_step``).  A save writes the new directory
beside the old one and swaps it in, then the layout sidecar, then the data
sidecar, each by an atomic rename; a crash between the two directory
renames leaves ``<path>.old`` and no ``path``, which
:func:`validate_checkpoint` reports and :func:`restore_latest_valid` skips.

Reading the reference's Orbax checkpoints would need JAX and is out of
scope; so is its backfill of the format without ``loss`` (the port's format
has no older version).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings
import zlib
from typing import Any, List, Optional, Sequence

import torch

from dpwa_tpu_torch.optim import AdamState
from dpwa_tpu_torch.parallel.stacked import StackedTrainState
from dpwa_tpu_torch.utils.pytree import FlatParams

FORMAT = "dpwa_tpu_torch.checkpoint/1"
MANIFEST = "manifest.json"
TENSORS = "tensors.pt"
_STATE_CLASSES = {"StackedTrainState": StackedTrainState}
# The dataclasses an optimizer state may hold, by name.
_RECORDS = {"AdamState": AdamState}
_CHUNK = 1 << 24


def _data_state_path(path: str) -> str:
    """Sidecar for the data-stream state, a sibling of the checkpoint."""
    return path.rstrip(os.sep) + "-data.json"


def _layout_path(path: str) -> str:
    """Sidecar recording which state class was saved."""
    return path.rstrip(os.sep) + "-meta.json"


def _write_json(path: str, obj) -> None:
    """``obj`` as JSON at ``path``, atomically (a temporary file renamed)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class _Crc32Writer:
    """A file wrapper that keeps the CRC-32 and the count of what passes."""

    def __init__(self, f):
        self.f, self.crc, self.n = f, 0, 0

    def write(self, data) -> int:
        self.crc = zlib.crc32(data, self.crc)
        self.n += len(data)
        return self.f.write(data)

    def flush(self) -> None:
        self.f.flush()


def _host(t: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous CPU copy of ``t`` (a view would save its whole
    storage)."""
    return torch.empty(t.shape, dtype=t.dtype).copy_(t.detach())


def _encode(value, key: str, tensors: dict):
    """The JSON structure of ``value``; its tensors go into ``tensors``."""
    if value is None:
        return None
    if isinstance(value, FlatParams):
        tensors[key] = _host(value.flat)
        first = value.first
        return {
            "flat": key, "names": list(value.names), "shapes": [list(s) for s in value.shapes],
            "first": None if first is None else [n for n in value.names if first(n)],
            "axes": {name: list(perm) for name, perm in value.axes.items()},
        }
    if isinstance(value, torch.Tensor):
        tensors[key] = _host(value)
        return {"tensor": key}
    if dataclasses.is_dataclass(value) and _RECORDS.get(type(value).__name__) is type(value):
        return {"record": type(value).__name__, "fields": {
            f.name: _encode(getattr(value, f.name), f"{key}.{f.name}", tensors)
            for f in dataclasses.fields(value)
        }}
    if isinstance(value, (bool, int, float)):
        return {"value": value}
    raise TypeError(f"cannot checkpoint {key} of type {type(value).__name__}")


def _flat_from_spec(spec, n: int) -> FlatParams:
    first = None if spec["first"] is None else set(spec["first"]).__contains__
    axes = {name: tuple(perm) for name, perm in spec.get("axes", {}).items()}
    return FlatParams(spec["names"], [tuple(s) for s in spec["shapes"]], n, first=first, axes=axes)


def _decode(spec, tensors: dict):
    """A new value from its structure, tensors on the CPU."""
    if spec is None:
        return None
    if "flat" in spec:
        t = tensors[spec["flat"]]
        flat = _flat_from_spec(spec, t.shape[0])
        flat.flat.copy_(t)
        return flat
    if "tensor" in spec:
        return tensors[spec["tensor"]]
    if "record" in spec:
        return _RECORDS[spec["record"]](
            **{k: _decode(v, tensors) for k, v in spec["fields"].items()})
    return spec["value"]


def _restore_into(spec, like, tensors: dict, where: str, write: bool):
    """``spec``'s values copied into ``like`` (in place, on ``like``'s
    devices) when ``write``; returns the restored value.  Raises
    ``ValueError`` where the saved structure or layout differs from
    ``like``'s (checked alone when not ``write``)."""
    def mismatch(what):
        return ValueError(f"checkpoint {where}: {what} does not match like's")

    if spec is None or like is None:
        if spec is not None or like is not None:
            raise mismatch("presence")
        return None
    if "flat" in spec:
        if not isinstance(like, FlatParams):
            raise mismatch("type")
        t = tensors[spec["flat"]]
        layout = (list(like.names), [list(s) for s in like.shapes], like.n_peers)
        if layout != (spec["names"], spec["shapes"], t.shape[0]):
            raise mismatch("FlatParams layout (names, shapes, peers)")
        first = like.first
        like_first = None if first is None else [n for n in like.names if first(n)]
        if like_first != spec["first"]:
            raise mismatch("FlatParams column order (its leading leaves)")
        if write:
            like.flat.copy_(t)
        return like
    if "tensor" in spec:
        t = tensors[spec["tensor"]]
        if not isinstance(like, torch.Tensor) or like.shape != t.shape or like.dtype != t.dtype:
            raise mismatch("tensor shape or dtype")
        if write:
            like.copy_(t)
        return like
    if "record" in spec:
        if type(like).__name__ != spec["record"]:
            raise mismatch("record type")
        if set(spec["fields"]) != {f.name for f in dataclasses.fields(like)}:
            raise mismatch("record fields")
        for name, field_spec in spec["fields"].items():
            value = _restore_into(field_spec, getattr(like, name), tensors, f"{where}.{name}", write)
            if write:
                setattr(like, name, value)
        return like
    if type(like) is not type(spec["value"]):
        raise mismatch("value type")
    return spec["value"]


def save_checkpoint(path: str, state, data_stream=None) -> None:
    """Atomically save a training state to ``path`` (a directory).

    ``data_stream`` (anything with ``state_dict()``, e.g.
    :class:`~dpwa_tpu_torch.data.PeerBatchStream`) also saves the per-peer
    dataset position in a JSON sidecar beside the directory, stamped with
    the state's ``step``, so a resumed run replays the exact batch
    sequence; without it a resume keeps the exchange schedule but not the
    batches.  The caller makes sure the device has finished the step (the
    copies to the host wait for it)."""
    path = os.path.abspath(path)
    sidecar = _data_state_path(path)
    # The previous save's sidecar stays until the new one replaces it: a
    # crash during the write below leaves the old checkpoint with its
    # sidecar, and the ckpt_step stamp guards against a stale pairing.  A
    # legacy unstamped sidecar cannot be checked against the new state, so
    # it goes first.
    if os.path.exists(sidecar):
        try:
            with open(sidecar) as f:
                old = json.load(f)
        except (OSError, json.JSONDecodeError):
            old = None
        if not (isinstance(old, dict) and "ckpt_step" in old):
            os.remove(sidecar)
    tensors: dict = {}
    fields = {f.name: _encode(getattr(state, f.name), f.name, tensors)
              for f in dataclasses.fields(state) if f.name != "step"}
    tmp, old = path + ".tmp", path + ".old"
    for stale in (tmp, old):
        if os.path.isdir(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp)
    with open(os.path.join(tmp, TENSORS), "wb") as f:
        writer = _Crc32Writer(f)
        torch.save(tensors, writer)
        f.flush()
        os.fsync(f.fileno())
    _write_json(os.path.join(tmp, MANIFEST), {
        "format": FORMAT, "layout": type(state).__name__, "step": int(state.step),
        "fields": fields,
        "tensors": {k: {"shape": list(t.shape), "dtype": str(t.dtype).removeprefix("torch.")}
                    for k, t in tensors.items()},
        "tensors_bytes": writer.n, "tensors_crc32": writer.crc,
    })
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.isdir(old):
        shutil.rmtree(old)
    _write_json(_layout_path(path), {"layout": type(state).__name__})
    if data_stream is not None:
        _write_json(sidecar, {"ckpt_step": int(state.step), "data": data_stream.state_dict()})
    elif os.path.exists(sidecar):
        # A re-save without a stream: drop the previous save's sidecar, only
        # now that the new checkpoint is in place.
        os.remove(sidecar)


def _read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    return manifest


def _load_tensors(path: str, manifest: dict) -> dict:
    """The tensor file, its size and CRC-32 checked against the manifest."""
    name = os.path.join(path, TENSORS)
    crc, size = 0, 0
    with open(name, "rb") as f:
        while chunk := f.read(_CHUNK):
            crc, size = zlib.crc32(chunk, crc), size + len(chunk)
    if (size, crc) != (manifest["tensors_bytes"], manifest["tensors_crc32"]):
        raise ValueError(f"{name}: {size} bytes with CRC-32 {crc}, the manifest says "
                         f"{manifest['tensors_bytes']} with {manifest['tensors_crc32']}")
    return torch.load(name, map_location="cpu", weights_only=True)


def _read_data_sidecar(path: str, step: int):
    """The saved stream position for a checkpoint at ``step``; raises when
    the sidecar is missing or stamped for another step."""
    sidecar = _data_state_path(path)
    if not os.path.exists(sidecar):
        raise FileNotFoundError(
            f"checkpoint {path} has no data-stream sidecar ({sidecar}); it was "
            "saved without data_stream= and resuming this stream would replay "
            "different batches"
        )
    with open(sidecar) as f:
        payload = json.load(f)
    if isinstance(payload, dict) and "ckpt_step" in payload:
        if int(payload["ckpt_step"]) != step:
            raise ValueError(
                f"data-stream sidecar {sidecar} was written for step "
                f"{payload['ckpt_step']} but the checkpoint holds step {step}; "
                "refusing to pair a stale stream position with this state (a "
                "crash likely interrupted the save that would have replaced it)"
            )
        return payload["data"]
    return payload  # a sidecar from before the stamp: the raw state_dict


def restore_checkpoint(path: str, like: Optional[Any] = None, data_stream=None):
    """Restore a state saved by :func:`save_checkpoint`.

    With ``like`` (a state of the same layout: the same FlatParams names,
    shapes and column order, the same optimizer state), every saved tensor
    is copied into ``like``'s tensor on ``like``'s device — the train step
    updates its buffers in place, and the optimizer's state and the views
    are built on them — and ``like``, restored, is returned; a layout
    mismatch raises ``ValueError`` before anything is copied.  Without
    ``like``, the state comes back on the CPU in the class the layout
    sidecar names.

    ``data_stream`` (``load_state_dict()``-capable) gets the dataset
    position saved with this checkpoint; raises if there is none, or if it
    was stamped for another step, before any tensor is read."""
    path = os.path.abspath(path)
    manifest = _read_manifest(path)
    step = int(manifest["step"])
    stream_state = None if data_stream is None else _read_data_sidecar(path, step)
    tensors = _load_tensors(path, manifest)
    if like is not None:
        if type(like).__name__ != manifest["layout"]:
            raise ValueError(f"checkpoint {path} holds a {manifest['layout']}, like is a "
                             f"{type(like).__name__}")
        if set(manifest["fields"]) != {f.name for f in dataclasses.fields(like)} - {"step"}:
            raise ValueError(f"checkpoint {path}: its fields do not match like's")
        for write in (False, True):  # check everything, then copy
            for name, spec in manifest["fields"].items():
                value = _restore_into(spec, getattr(like, name), tensors, name, write)
                if write:
                    setattr(like, name, value)
        like.step = step
        state = like
    else:
        layout = _layout_path(path)
        name = manifest["layout"]
        if os.path.exists(layout):
            with open(layout) as f:
                name = json.load(f).get("layout", name)
        fields = {k: _decode(spec, tensors) for k, spec in manifest["fields"].items()}
        state = _STATE_CLASSES[name](step=step, **fields)
    if data_stream is not None:
        data_stream.load_state_dict(stream_state)
    return state


def validate_checkpoint(path: str, data_stream: bool = False) -> Optional[str]:
    """A structural health check that reads no tensor data: None when the
    checkpoint looks sound, else the reason.

    - ``path`` is a directory with a parseable manifest of this format (a
      save that died before its commit has none);
    - the tensor file exists with the size the manifest records (a
      truncated file fails here; a corrupted one fails its CRC at
      restore);
    - the layout sidecar, when present, is valid JSON;
    - with ``data_stream=True``, the data sidecar exists, parses and, when
      stamped, matches the manifest's step."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return "not a directory"
    try:
        manifest = _read_manifest(path)
        size = os.path.getsize(os.path.join(path, TENSORS))
    except (OSError, ValueError) as e:
        return f"unreadable checkpoint: {type(e).__name__}: {e}"
    if size != manifest.get("tensors_bytes"):
        return f"tensor file holds {size} bytes, the manifest says {manifest.get('tensors_bytes')}"
    layout = _layout_path(path)
    if os.path.exists(layout):
        try:
            with open(layout) as f:
                json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return f"corrupt layout sidecar: {e}"
    if data_stream:
        sidecar = _data_state_path(path)
        if not os.path.exists(sidecar):
            return "missing data-stream sidecar"
        try:
            with open(sidecar) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return f"corrupt data-stream sidecar: {e}"
        if (
            isinstance(payload, dict)
            and "ckpt_step" in payload
            and int(payload["ckpt_step"]) != int(manifest["step"])
        ):
            return (
                f"data-stream sidecar stamped step {payload['ckpt_step']} "
                f"!= checkpoint step {manifest['step']}"
            )
    return None


def restore_latest_valid(paths: Sequence[str], like: Optional[Any] = None, data_stream=None):
    """Restore the newest sound checkpoint of ``paths`` (ordered oldest to
    newest): each candidate, newest first, is vetted with
    :func:`validate_checkpoint` (with the data sidecar when ``data_stream``
    is given) and then restored; one that fails either is skipped with a
    ``UserWarning`` naming it and why.  Raises ``FileNotFoundError`` when
    none survives.  :func:`restore_checkpoint` keeps its strict contract
    for a caller that names one checkpoint."""
    reasons: List[str] = []
    for path in reversed(list(paths)):
        reason = validate_checkpoint(path, data_stream=data_stream is not None)
        if reason is None:
            try:
                return restore_checkpoint(path, like=like, data_stream=data_stream)
            except Exception as e:  # any fault of this candidate: try the next
                reason = f"restore failed: {type(e).__name__}: {e}"
        reasons.append(f"{path}: {reason}")
        warnings.warn(
            f"skipping checkpoint {path} ({reason}); falling back to an earlier one",
            stacklevel=2,
        )
    raise FileNotFoundError(
        "no valid checkpoint among candidates: " + "; ".join(reasons)
        if reasons
        else "no checkpoint candidates given"
    )
