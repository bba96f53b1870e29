"""Compact Llama-family decoder with LoRA (the port of
:mod:`dpwa_tpu.models.llama`).

RMSNorm, rotary position embeddings, grouped-query causal attention and a
SwiGLU MLP, with a rank-r LoRA delta beside every dense kernel; only the
LoRA leaves train and gossip (:func:`lora_filter`).  Module and parameter
names mirror the Flax model's, so a parameter's name here is its Flax key
path with dots: ``layer_0.attn.wq.lora_a`` is ``params/layer_0/attn/wq/
lora_a`` there.  Kernels keep Flax's ``[in, out]`` layout and every
parameter is float32, as Flax stores them, so parameters carry across
unchanged (:mod:`dpwa_tpu_torch.convert`).

The modules hold their parameters on the ``meta`` device: a call takes
real ones from a ``{name: tensor}`` dict through
``torch.func.functional_call`` (:func:`init` makes them), so a
Llama-3-8B-wide model costs no memory until its parameters are made.

The compute types follow JAX's promotion, written out (``torch.matmul``
does not mix float32 and bfloat16):

- the embedding output is in ``cfg.dtype`` (rows gathered, then cast);
- :class:`RMSNorm` returns ``(x·rsqrt(mean x² + ε)).astype(dtype) · scale``
  with a float32 ``scale``, which promotes to float32 — so with
  ``dtype=bfloat16`` every later activation is float32, and the attention
  gets float32 q, k and v;
- a dense layer computes ``x @ kernel.astype(dtype)`` in the promoted type
  of the two, and the LoRA term ``((x @ A) @ B) · (α/r)`` in that order;
- ``lm_head`` computes in float32.

Attention is :func:`dpwa_tpu_torch.ops.ulysses.single_device_attention`.
With ``sp_axis`` set the model is sequence-parallel over a virtual axis of
that name, whose size a caller binds (:func:`dpwa_tpu_torch.parallel.
virtual_axis.bind`, as the reference's ``shard_map`` binds its mesh axis):
the model takes the whole sequence, ``sp`` blocks in the ``sp_layout``
order, rope gets the blocks' global positions, and attention is the ring
(:mod:`~dpwa_tpu_torch.ops.ring_attention`, or
:mod:`~dpwa_tpu_torch.ops.zigzag_ring` for the zigzag layout) or Ulysses
(``sp_strategy="a2a"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dpwa_tpu_torch.ops.ring_attention import ring_attention_local
from dpwa_tpu_torch.ops.ulysses import single_device_attention, ulysses_attention_local
from dpwa_tpu_torch.ops.zigzag_ring import zigzag_positions, zigzag_ring_attention
from dpwa_tpu_torch.parallel import virtual_axis
from dpwa_tpu_torch.utils import flax_rng, prng


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # GQA; None = MHA
    d_ff: int = 1376
    max_seq_len: int = 2048
    rope_theta: float = 500000.0
    lora_rank: int = 0  # 0 = no LoRA
    lora_alpha: float = 16.0
    dtype: torch.dtype = torch.float32
    # Sequence-parallel: the name of the virtual axis the sequence is
    # split over (its size bound by the caller); None = single-device.
    sp_axis: Optional[str] = None
    # "contiguous" (rank i holds block i) or "zigzag" (rank i holds global
    # chunks i and 2n-1-i; callers order tokens with zigzag_shard).
    sp_layout: str = "contiguous"
    # "ring" (K/V blocks rotate: the hop kernels B3/B4) or "a2a" (Ulysses:
    # head-sharded attention over the whole sequence, B5 per rank).
    sp_strategy: str = "ring"
    # "auto" takes the flash kernels (B5, or B3/B4 in the ring) on the card
    # when the shapes fit them, "flash" forces them, "dense" forces the
    # einsum (the ring's q-chunked einsum hop).
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.attn_impl not in ("auto", "flash", "dense"):
            raise ValueError(
                f"attn_impl must be auto|flash|dense, got {self.attn_impl!r}"
            )
        if self.sp_layout not in ("contiguous", "zigzag"):
            raise ValueError(
                f"sp_layout must be contiguous|zigzag, got {self.sp_layout!r}"
            )
        if self.sp_layout != "contiguous" and self.sp_axis is None:
            raise ValueError(
                "sp_layout='zigzag' requires sp_axis (the layout only "
                "exists for the sequence-parallel ring)"
            )
        if self.sp_strategy not in ("ring", "a2a"):
            raise ValueError(
                f"sp_strategy must be ring|a2a, got {self.sp_strategy!r}"
            )
        if self.sp_strategy == "a2a" and self.sp_layout != "contiguous":
            raise ValueError(
                "sp_strategy='a2a' shards heads, not sequence stripes — "
                "the zigzag layout only applies to the ring strategy"
            )

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def llama3_8b_config(lora_rank: int = 16) -> LlamaConfig:
    """The real Llama-3-8B dimensions (public architecture constants)."""
    return LlamaConfig(
        vocab_size=128256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        max_seq_len=8192,
        rope_theta=500000.0,
        lora_rank=lora_rank,
        dtype=torch.bfloat16,
    )


def lora_filter(path: str) -> bool:
    """Subset predicate: the LoRA adapter leaves (and nothing else)."""
    return "lora_" in path


def _meta(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta"), requires_grad=False)


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted type of the two, as jnp's ``@``."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype)


class LoRADense(nn.Module):
    """Dense with a rank-r LoRA delta: ``y = x·W + (α/r)·x·A·B``."""

    def __init__(self, in_features: int, features: int, rank: int,
                 alpha: float = 16.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rank, self.dtype = rank, dtype
        self.scale = alpha / rank if rank > 0 else 0.0
        self.kernel = _meta(in_features, features)
        if rank > 0:
            self.lora_a = _meta(in_features, rank)
            self.lora_b = _meta(rank, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _matmul(x, self.kernel.to(self.dtype))
        if self.rank > 0:
            a, b = self.lora_a.to(self.dtype), self.lora_b.to(self.dtype)
            y = y + _matmul(_matmul(x, a), b) * self.scale
        return y


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = _meta(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.to(torch.float32).square().mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(self.dtype) * self.scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last (head_dim) axis. x: [..., T, H, D]."""
    d = x.shape[-1]
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exponent)
    angles = positions[..., None].to(torch.float32) * freqs  # [T, D/2]
    cos = torch.cos(angles)[..., None, :]  # [T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x1 * sin + x2 * cos
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def _dense(cfg: LlamaConfig, in_features: int, features: int) -> LoRADense:
    return LoRADense(in_features, features, cfg.lora_rank, cfg.lora_alpha, cfg.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        self.wq = _dense(cfg, cfg.d_model, H * D)
        self.wk = _dense(cfg, cfg.d_model, KV * D)
        self.wv = _dense(cfg, cfg.d_model, KV * D)
        self.wo = _dense(cfg, H * D, cfg.d_model)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = x.shape
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q = self.wq(x).reshape(B, T, H, D)
        k = self.wk(x).reshape(B, T, KV, D)
        v = self.wv(x).reshape(B, T, KV, D)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cfg.sp_axis is None:
            out = single_device_attention(q, k, v, causal=True, impl=cfg.attn_impl)
        else:
            sp = virtual_axis.axis_size(cfg.sp_axis)
            if cfg.sp_strategy == "a2a":
                out = ulysses_attention_local(q, k, v, sp, causal=True, impl=cfg.attn_impl)
            elif cfg.sp_layout == "zigzag":
                impl = "jnp" if cfg.attn_impl == "dense" else None
                out = zigzag_ring_attention(q, k, v, sp, impl=impl)
            else:
                impl = "xla" if cfg.attn_impl == "dense" else cfg.attn_impl
                out = ring_attention_local(q, k, v, sp, causal=True, impl=impl)
        return self.wo(out.reshape(B, T, H * D))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.w_gate = _dense(cfg, cfg.d_model, cfg.d_ff)
        self.w_up = _dense(cfg, cfg.d_model, cfg.d_ff)
        self.w_down = _dense(cfg, cfg.d_ff, cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, dtype=cfg.dtype)
        self.attn = Attention(cfg)
        self.mlp_norm = RMSNorm(cfg.d_model, dtype=cfg.dtype)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class Embed(nn.Module):
    """Flax ``nn.Embed``: the ``[vocab, d]`` table's rows, in ``dtype``."""

    def __init__(self, vocab: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = _meta(vocab, features)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        # Gathering before the cast gives Flax's values (it casts the whole
        # table) without a full-table copy per call.
        return self.embedding[tokens.long()].to(self.dtype)


class Head(nn.Module):
    """Flax ``nn.Dense(vocab, use_bias=False, dtype=float32)``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = _meta(in_features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _matmul(x.to(torch.float32), self.kernel)


class Llama(nn.Module):
    """Decoder-only LM; ``forward(tokens [B, T])`` returns float32 logits
    ``[B, T, vocab]``.  Call it through ``functional_call`` (or
    :func:`apply`) with real parameters; with ``sp_axis``, inside
    ``virtual_axis.bind(sp_axis, sp)`` and with T divisible by ``sp``
    (``2·sp`` for zigzag)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype)
        for i in range(cfg.n_layers):
            setattr(self, f"layer_{i}", Block(cfg))
        self.final_norm = RMSNorm(cfg.d_model, dtype=cfg.dtype)
        self.lm_head = Head(cfg.d_model, cfg.vocab_size)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        T = tokens.shape[-1]
        x = self.embed(tokens)
        if self.cfg.sp_layout == "zigzag":  # the tokens' global positions
            sp = virtual_axis.axis_size(self.cfg.sp_axis)
            positions = zigzag_positions(T, sp, device=x.device)
        else:  # one block, or sp contiguous blocks in order
            positions = torch.arange(T, device=x.device)
        for i in range(self.cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, positions)
        return self.lm_head(self.final_norm(x))


def apply(model: Llama, params, tokens: torch.Tensor) -> torch.Tensor:
    """``model(tokens)`` with the ``{name: tensor}`` parameters ``params``."""
    return torch.func.functional_call(model, params, (tokens,))


def param_shapes(model: Llama) -> dict[str, tuple[int, ...]]:
    """``{name: shape}`` of every parameter."""
    return {name: tuple(p.shape) for name, p in model.named_parameters()}


def init(model: Llama, key: prng.Key, device=None) -> dict[str, torch.Tensor]:
    """Fresh float32 parameters on ``device`` (the CPU by default), the ones
    Flax's ``model.init(key, …)`` makes: each leaf drawn from its own key
    (:func:`~dpwa_tpu_torch.utils.flax_rng.param_key`) with the reference's
    initialiser, truncated lecun-normal kernels, the embedding's
    ``variance_scaling(1, fan_in, normal, out_axis=0)``, ``lora_a``
    ``normal(0.02)`` (the second parameter of its LoRADense), zero
    ``lora_b`` and unit norm scales.  The port keeps Flax's layouts, so no
    leaf is transposed."""
    params = {}
    for name, shape in param_shapes(model).items():
        *path, leaf = name.split(".")
        if leaf == "kernel":
            t = flax_rng.lecun_normal(flax_rng.param_key(key, path, 1), shape, device)
        elif leaf == "embedding":
            t = flax_rng.embed_normal(flax_rng.param_key(key, path, 1), shape, device)
        elif leaf == "lora_a":
            t = flax_rng.normal(flax_rng.param_key(key, path, 2), shape, 0.02, device)
        elif leaf == "lora_b":
            t = torch.zeros(shape, dtype=torch.float32, device=device)
        elif leaf == "scale":
            t = torch.ones(shape, dtype=torch.float32, device=device)
        else:  # pragma: no cover - every leaf above is named
            raise ValueError(f"no initialiser for {name}")
        params[name] = t
    return params
