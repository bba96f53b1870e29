"""Carry parameters between the Flax models and the port's.

ResNet and the MNIST ConvNets (:func:`flax_to_torch`, :func:`torch_to_flax`;
the CIFAR ResNets, ResNet-50's 161 leaves, ``ConvNet`` and ``SmallNet``
alike): Flax keeps a conv kernel as HWIO and a Dense kernel as ``[in,
out]``; the port's modules (:mod:`dpwa_tpu_torch.models.resnet`,
:mod:`dpwa_tpu_torch.models.mnist`) keep OIHW and ``[out, in]``.  Names
map one to one: the Flax key path ``params/BasicBlock_0/Conv_0/kernel`` is
the port's ``BasicBlock_0.Conv_0.kernel``; :func:`reference_axes` gives
the same carry as axis orders, for a flat buffer to ship its leaves in
the reference's element order.  ``collection="batch_stats"``
carries BatchNorm's running statistics (``batch_stats/BatchNorm_0/mean``
↔ ``BatchNorm_0.mean``, unchanged inside).  Both directions work on numpy
arrays, so tests can hand the same parameters to both packages and compare
the updated ones.  A leading peer axis (``stacked=True``) rides along
untouched.

Llama (:func:`flax_llama_to_torch`, :func:`torch_llama_to_flax`) and BERT
(:func:`flax_bert_to_torch`, :func:`torch_bert_to_flax`): the port keeps
Flax's layouts (kernels ``[in, out]``, the attention's ``[d, heads,
head_dim]``, the embeddings ``[vocab, d]``), so only the names change,
``params/layer_0/attn/wq/lora_a`` ↔ ``layer_0.attn.wq.lora_a``, with or
without a leading peer axis.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from dpwa_tpu_torch.utils.pytree import leaf_order


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


def _axes(name: str, ndim: int, perms: Mapping[int, tuple]) -> tuple | None:
    """The axis order that carries leaf ``name`` of rank ``ndim`` across,
    or None for a leaf both packages lay out alike."""
    return perms.get(ndim) if name.endswith("kernel") else None


def _carry(name: str, value, lead: int, perms: Mapping[int, tuple]) -> np.ndarray:
    value = np.asarray(value)
    perm = _axes(name, value.ndim - lead, perms)
    if perm is not None:
        value = value.transpose(*range(lead), *(lead + a for a in perm))
    return np.array(value, order="C")  # a writable copy


def flax_to_torch(variables: Mapping[str, Any], *, stacked: bool = False,
                  collection: str = "params") -> Dict[str, np.ndarray]:
    """Flax ResNet or ConvNet variables (``{"params": {...}, ...}`` or the
    collection's dict itself, nested dicts of arrays) → ``{port name:
    array}`` for ``collection`` (``"params"`` or ``"batch_stats"``)."""
    tree = variables.get(collection, variables)
    lead = 1 if stacked else 0
    named = {".".join(path): value for path, value in _flatten(tree).items()}
    return {name: _carry(name, value, lead, _TO_PORT) for name, value in named.items()}


def torch_to_flax(named: Mapping[str, Any], *, stacked: bool = False,
                  collection: str = "params") -> Dict[str, Any]:
    """``{port name: array}`` → Flax variables ``{collection: {...}}``."""
    lead = 1 if stacked else 0
    tree: Dict[str, Any] = {}
    for name, value in named.items():
        node = tree
        *parents, leaf = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = _carry(name, value, lead, _TO_FLAX)
    return {collection: tree}


def reference_axes(shapes: Mapping[str, Any]) -> Dict[str, tuple]:
    """For a ResNet's or ConvNet's leaves (``{port name: shape}``, or
    ``{port name: tensor}``, no peer axis): the axis order that lays each
    leaf out as the reference does, the one :func:`torch_to_flax` applies,
    for the leaves whose layouts differ (the conv and Dense kernels).  A
    :class:`~dpwa_tpu_torch.utils.pytree.FlatParams` given these ``axes``
    ships its leaves in the reference's element order (the int8 wire's
    chunks, the TCP frame)."""
    out = {}
    for name, shape in shapes.items():
        perm = _axes(name, len(tuple(getattr(shape, "shape", shape))), _TO_FLAX)
        if perm is not None:
            out[name] = perm
    return out


def _by_name_to_torch(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    params = variables.get("params", variables)
    named = {".".join(path): value for path, value in _flatten(params).items()}
    return {name: np.array(named[name], order="C") for name in leaf_order(named)}


def _by_name_to_flax(named: Mapping[str, Any]) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    for name in leaf_order(named):
        node = params
        *parents, leaf = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = np.array(named[name], order="C")
    return {"params": params}


def flax_llama_to_torch(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax Llama variables (``{"params": {...}}`` or the params dict) →
    ``{port name: array}`` (writable copies) in the reference's leaf order,
    ``embed.embedding``, ``final_norm.scale``, ``layer_0.…``,
    ``lm_head.kernel``."""
    return _by_name_to_torch(variables)


def torch_llama_to_flax(named: Mapping[str, Any]) -> Dict[str, Any]:
    """``{port name: array}`` → Flax Llama variables ``{"params": {...}}``."""
    return _by_name_to_flax(named)


def flax_bert_to_torch(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax BERT variables (``{"params": {...}}`` or the params dict) →
    ``{port name: array}`` (writable copies) in the reference's leaf order,
    ``embed_ln.bias``, …, ``layer_0.attn.key.bias``, …, ``pos_embed``,
    ``tok_embed.embedding``; a leading peer axis rides along."""
    return _by_name_to_torch(variables)


def torch_bert_to_flax(named: Mapping[str, Any]) -> Dict[str, Any]:
    """``{port name: array}`` → Flax BERT variables ``{"params": {...}}``,
    with or without a leading peer axis."""
    return _by_name_to_flax(named)
