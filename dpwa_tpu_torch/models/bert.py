"""BERT-style masked-LM encoder (the port of :mod:`dpwa_tpu.models.bert`,
BASELINE config 4).

Learned positions, post-LN encoder blocks with Flax's multi-head
dot-product attention, a tanh-GELU feed-forward, and an MLM head;
:func:`bert_base_config` carries the real BERT-base dimensions (12 layers,
d 768, 12 heads, d_ff 3072, vocab 30522: 132,953,658 parameters in 202
leaves), tests use :func:`bert_tiny_config`.  The hierarchical averaging
is a schedule (:mod:`dpwa_tpu_torch.parallel.schedules`), not a property of
the model.

Module and parameter names mirror the Flax model's and every parameter
keeps Flax's layout and float32 type, so parameters carry across by name
alone (:func:`dpwa_tpu_torch.convert.flax_bert_to_torch`): Dense kernels
``[in, out]``, the attention's ``query``/``key``/``value`` kernels
``[d, heads, head_dim]`` and ``out`` ``[heads, head_dim, d]``, the root's
``pos_embed`` ``[max_seq_len, d]``.  As in :mod:`~dpwa_tpu_torch.models.
llama`, the modules hold their parameters on the ``meta`` device and a call
takes real ones through ``torch.func.functional_call`` (:func:`apply`).

The arithmetic follows Flax 0.12's modules, written out:

- attention (``nn.dot_product_attention``): q divided by √head_dim before
  the product ``q·kᵀ``, masked positions set to the dtype's lowest value,
  the softmax, then the product with v — explicit products, no fused
  attention call (whose backends change the arithmetic);
- LayerNorm: ε = 1e-6 and Flax's fast variance E[x²] − E[x]² (clamped at
  0) in float32, then ``(x − μ)·(rsqrt(var + ε)·scale) + bias``;
- GELU: the tanh approximation (``jax.nn.gelu``'s default);
- dtypes: ``cfg.dtype`` (bfloat16 under ``--bf16``) is the compute type of
  the attention and of the Dense layers, which cast their input and
  parameters to it; the embeddings, the LayerNorms (float32 parameters
  promote them) and ``mlm_head`` compute in float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dpwa_tpu_torch.train import softmax_cross_entropy_with_integer_labels
from dpwa_tpu_torch.utils import flax_rng, prng


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def bert_base_config(dtype=None) -> BertConfig:
    return BertConfig(**({} if dtype is None else {"dtype": dtype}))


def bert_tiny_config(dtype=None) -> BertConfig:
    return BertConfig(
        vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
        max_seq_len=64,
        **({} if dtype is None else {"dtype": dtype}),
    )


def _meta(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta"), requires_grad=False)


class Dense(nn.Module):
    """Flax ``nn.DenseGeneral`` over the last ``len(in_shape)`` axes:
    kernel ``[*in_shape, *out_shape]``, bias ``out_shape``; input, kernel
    and bias are cast to ``dtype`` (``nn.Dense`` is one input axis and one
    output axis)."""

    def __init__(self, in_shape: tuple[int, ...], out_shape: tuple[int, ...],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_shape, self.out_shape, self.dtype = in_shape, out_shape, dtype
        self.kernel = _meta(*in_shape, *out_shape)
        self.bias = _meta(*out_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[: x.dim() - len(self.in_shape)]
        k_in, k_out = math.prod(self.in_shape), math.prod(self.out_shape)
        x = x.reshape(*lead, k_in).to(self.dtype)
        y = x @ self.kernel.to(self.dtype).reshape(k_in, k_out)
        return (y + self.bias.to(self.dtype).reshape(k_out)).reshape(*lead, *self.out_shape)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm()`` (ε 1e-6, the fast variance), in float32."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = _meta(features)
        self.bias = _meta(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (xf - mean) * mul + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """Flax ``nn.MultiHeadDotProductAttention(num_heads, dtype)`` over
    ``x`` as query, key and value; ``mask`` (bool, broadcast to
    ``[B, heads, T, T]``) keeps the positions where it is true."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
        self.dtype = cfg.dtype
        self.query = Dense((d,), (h, dh), cfg.dtype)
        self.key = Dense((d,), (h, dh), cfg.dtype)
        self.value = Dense((d,), (h, dh), cfg.dtype)
        self.out = Dense((h, dh), (d,), cfg.dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, T, H, Dh]
        q = q / math.sqrt(q.shape[-1])
        scores = q.transpose(-3, -2) @ k.transpose(-3, -2).transpose(-2, -1)  # [B, H, T, T]
        if mask is not None:
            scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores.to(torch.float32), dim=-1).to(self.dtype)
        return self.out((weights @ v.transpose(-3, -2)).transpose(-3, -2))


class EncoderBlock(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attn = MultiHeadDotProductAttention(cfg)
        self.attn_ln = LayerNorm(cfg.d_model)
        self.ff_in = Dense((cfg.d_model,), (cfg.d_ff,), cfg.dtype)
        self.ff_out = Dense((cfg.d_ff,), (cfg.d_model,), cfg.dtype)
        self.ff_ln = LayerNorm(cfg.d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        x = self.attn_ln(x + self.attn(x, mask))
        h = self.ff_out(F.gelu(self.ff_in(x), approximate="tanh"))
        return self.ff_ln(x + h)


class Embed(nn.Module):
    """Flax ``nn.Embed``: rows of the float32 ``[vocab, d]`` table."""

    def __init__(self, vocab: int, features: int):
        super().__init__()
        self.embedding = _meta(vocab, features)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding[tokens.long()]


class BertMLM(nn.Module):
    """Encoder and MLM head; ``forward(tokens [B, T], attention_mask=None)``
    returns float32 logits ``[B, T, vocab]``.  ``attention_mask`` ``[B, T]``
    (nonzero: attend) masks the keys, as the reference's
    ``attention_mask[:, None, None, :]``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model)
        self.pos_embed = _meta(cfg.max_seq_len, cfg.d_model)
        self.embed_ln = LayerNorm(cfg.d_model)
        for i in range(cfg.n_layers):
            setattr(self, f"layer_{i}", EncoderBlock(cfg))
        self.mlm_dense = Dense((cfg.d_model,), (cfg.d_model,), cfg.dtype)
        self.mlm_ln = LayerNorm(cfg.d_model)
        self.mlm_head = Dense((cfg.d_model,), (cfg.vocab_size,), torch.float32)

    def forward(self, tokens: torch.Tensor, attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        T = tokens.shape[-1]
        x = self.tok_embed(tokens) + self.pos_embed[:T]
        x = self.embed_ln(x)
        mask = None
        if attention_mask is not None:
            mask = (attention_mask != 0)[..., None, None, :]
        for i in range(self.cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        x = self.mlm_ln(F.gelu(self.mlm_dense(x), approximate="tanh"))
        return self.mlm_head(x)


def apply(model: BertMLM, params, tokens: torch.Tensor,
          attention_mask: torch.Tensor | None = None) -> torch.Tensor:
    """``model(tokens, attention_mask)`` with the ``{name: tensor}``
    parameters ``params``."""
    return torch.func.functional_call(model, params, (tokens, attention_mask))


def param_shapes(model: BertMLM) -> dict[str, tuple[int, ...]]:
    """``{name: shape}`` of every parameter."""
    return {name: tuple(p.shape) for name, p in model.named_parameters()}


def init(model: BertMLM, key: prng.Key, device=None) -> dict[str, torch.Tensor]:
    """Fresh float32 parameters on ``device`` (the CPU by default), the ones
    Flax's ``model.init(key, …)`` makes: each leaf from its own key
    (:func:`~dpwa_tpu_torch.utils.flax_rng.param_key`; a kernel is its
    module's first parameter, a bias its second), kernels truncated
    lecun-normal drawn on the flattened ``[fan_in, fan_out]`` shape
    (:func:`~dpwa_tpu_torch.utils.flax_rng.dense_general_kernel`; the
    attention's ``out`` takes two input axes), the token table
    ``variance_scaling(1, fan_in, normal, out_axis=0)``, ``pos_embed``
    ``normal(0.02)`` (the root module's only parameter), zero biases and
    unit LayerNorm scales."""
    params = {}
    for name, shape in param_shapes(model).items():
        *path, leaf = name.split(".")
        if leaf == "kernel":
            n_in = 2 if path[-1] == "out" else 1
            t = flax_rng.dense_general_kernel(flax_rng.param_key(key, path, 1), shape, n_in, device)
        elif leaf == "embedding":
            t = flax_rng.embed_normal(flax_rng.param_key(key, path, 1), shape, device)
        elif leaf == "pos_embed":
            t = flax_rng.normal(flax_rng.param_key(key, path, 1), shape, 0.02, device)
        elif leaf == "bias":
            t = torch.zeros(shape, dtype=torch.float32, device=device)
        elif leaf == "scale":
            t = torch.ones(shape, dtype=torch.float32, device=device)
        else:  # pragma: no cover - every leaf above is named
            raise ValueError(f"no initialiser for {name}")
        params[name] = t
    return params


MASK_TOKEN = 0  # convention for the synthetic MLM task


def mlm_mask_batch(
    tokens: np.ndarray, rng: np.random.Generator, mask_prob: float = 0.15
):
    """Standard MLM corruption: returns (inputs, targets, loss_weights)."""
    mask = rng.random(tokens.shape) < mask_prob
    inputs = np.where(mask, MASK_TOKEN, tokens)
    return inputs.astype(np.int32), tokens.astype(np.int32), mask.astype(
        np.float32
    )


def mlm_loss_fn(model: BertMLM):
    """Per-peer masked-LM loss for the gossip train step: the cross-entropy
    of the masked positions' logits, averaged over the masked positions
    (over at least one)."""

    def loss_fn(params, batch):
        inputs, targets, weights = batch
        logits = apply(model, params, inputs)
        losses = softmax_cross_entropy_with_integer_labels(logits, targets)
        return (losses * weights).sum() / torch.clamp_min(weights.sum(), 1.0)

    return loss_fn
