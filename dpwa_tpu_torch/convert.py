"""Carry ResNet parameters between the Flax layout and the port's.

Flax keeps a conv kernel as HWIO and a Dense kernel as ``[in, out]``; the
port's modules (:mod:`dpwa_tpu_torch.models.resnet`) keep OIHW and
``[out, in]``.  Names map one to one: the Flax key path
``params/BasicBlock_0/Conv_0/kernel`` is the port's
``BasicBlock_0.Conv_0.kernel``.  Both directions work on numpy arrays, so
tests can hand the same parameters to both packages and compare the
updated ones.  A leading peer axis (``stacked=True``) rides along
untouched.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> Dict[tuple, Any]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


# Axis order that carries a kernel across, by kernel rank.
_TO_PORT = {4: (3, 2, 0, 1), 2: (1, 0)}  # HWIO -> OIHW, [in, out] -> [out, in]
_TO_FLAX = {4: (2, 3, 1, 0), 2: (1, 0)}


def _carry(name: str, value, lead: int, perms: Mapping[int, tuple]) -> np.ndarray:
    value = np.asarray(value)
    perm = perms.get(value.ndim - lead) if name.endswith("kernel") else None
    if perm is not None:
        value = value.transpose(*range(lead), *(lead + a for a in perm))
    return np.array(value, order="C")  # a writable copy


def flax_to_torch(variables: Mapping[str, Any], *, stacked: bool = False) -> Dict[str, np.ndarray]:
    """Flax ResNet variables (``{"params": {...}}`` or the params dict
    itself, nested dicts of arrays) → ``{port name: array}``."""
    params = variables.get("params", variables)
    lead = 1 if stacked else 0
    named = {".".join(path): value for path, value in _flatten(params).items()}
    return {name: _carry(name, value, lead, _TO_PORT) for name, value in named.items()}


def torch_to_flax(named: Mapping[str, Any], *, stacked: bool = False) -> Dict[str, Any]:
    """``{port name: array}`` → Flax variables ``{"params": {...}}``."""
    lead = 1 if stacked else 0
    params: Dict[str, Any] = {}
    for name, value in named.items():
        node = params
        *parents, leaf = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = _carry(name, value, lead, _TO_FLAX)
    return {"params": params}
