"""ResNets for CIFAR-10 and ImageNet (the port of :mod:`dpwa_tpu.models.resnet`).

Module and parameter names mirror the Flax model's, so a parameter's name
here is its Flax key path: ``BasicBlock_3.Conv_2.kernel`` is
``params/BasicBlock_3/Conv_2/kernel`` there.  The layout inside a leaf is
PyTorch's (conv kernels OIHW, the Dense kernel ``[out, in]``);
:mod:`dpwa_tpu_torch.convert` carries parameters across.

The public call takes NHWC ``[B, H, W, 3]`` as the Flax model does and
computes in NCHW inside.  What matches Flax, and why it matters:

- ``Conv`` pads ``SAME``: for a stride-2 3×3 conv on an even size that is
  (0, 1) on H and W, not PyTorch's symmetric ``padding=1``; for the
  ImageNet stem's 7×7 stride-2 conv on 224 it is (2, 3), not 3.
- The ImageNet stem's 3×3 stride-2 ``max_pool`` pads ``SAME`` with −inf:
  (0, 1) on an even size (:func:`max_pool_same`); ``max_pool2d(padding=1)``
  would move every window by one.
- The bottleneck block strides its 3×3 conv, as Flax's does.
- ``GroupNorm`` uses 16 channels per group, epsilon 1e-6, and the variance
  ``E[x²] − E[x]²`` (Flax's ``use_fast_variance``), in float32.
- ``norm_type="batch"``: Flax's ``BatchNorm(momentum=0.9)``, epsilon 1e-5,
  normalising with the batch's statistics in training (the same fast
  variance) and with the running ones in evaluation.  The running
  statistics are model state, not parameters: :func:`apply_batch_norm`
  takes them and returns their update as new tensors (Flax's ``mutable=
  ["batch_stats"]``), ``momentum·old + (1 − momentum)·batch`` with the
  biased variance, so the step can run under ``torch.func.vmap``.
  ``F.batch_norm`` would update in place, with the unbiased variance.
- ``dtype`` is the compute type of convolutions and norms (bf16 compute,
  float32 parameters); the final Dense layer computes in float32.

Every model is built with the weights Flax's ``model.init`` draws from
``jax.random.key(0)`` (:func:`init`), on ``device``; :func:`batch_stats`
gives a BatchNorm model's initial running statistics.
"""

from __future__ import annotations

import contextvars
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from dpwa_tpu_torch import convert
from dpwa_tpu_torch.utils import flax_rng, prng
from dpwa_tpu_torch.utils.pytree import Leaves


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Flax ``nn.Conv`` without bias: SAME padding, kernel OIHW."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides = strides
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(features, in_features, kernel_size, kernel_size)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[-1]
        ph = _same_pads(x.shape[-2], k, self.strides)
        pw = _same_pads(x.shape[-1], k, self.strides)
        x = x.to(self.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = 0
        return F.conv2d(x, self.kernel.to(self.dtype), stride=self.strides,
                        padding=padding)


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm(num_groups=None, group_size=16)`` on NCHW."""

    def __init__(self, features: int, group_size: int = 16,
                 epsilon: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        if features % group_size:
            raise ValueError(f"{features} channels do not split into groups of {group_size}")
        self.groups = features // group_size
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xg = x.float().reshape(b, self.groups, c // self.groups, h, w)
        mean = xg.mean(dim=(2, 3, 4), keepdim=True)
        mean2 = (xg * xg).mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.epsilon)
        mul = mul * self.scale.reshape(1, self.groups, c // self.groups, 1, 1)
        y = (xg - mean) * mul + self.bias.reshape(1, self.groups, c // self.groups, 1, 1)
        return y.reshape(b, c, h, w).to(self.dtype)


class _BatchNormCall(NamedTuple):
    train: bool
    stats: dict  # {name: tensor}: the running statistics this call computes


_BATCH_NORM: contextvars.ContextVar[_BatchNormCall | None] = contextvars.ContextVar(
    "batch_norm_call", default=None
)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(use_running_average=not train, momentum=0.9)`` on
    NCHW, epsilon 1e-5: parameters ``scale`` and ``bias``; the running
    ``mean`` and ``var`` are buffers, read and updated only through
    :func:`apply_batch_norm`."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.path = ""  # its name in the model, set by the model
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        call = _BATCH_NORM.get()
        if call is None:
            raise RuntimeError("a norm_type='batch' model runs through resnet.apply_batch_norm")
        if call.train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            m = self.momentum
            call.stats[f"{self.path}.mean"] = m * self.mean + (1 - m) * mean
            call.stats[f"{self.path}.var"] = m * self.var + (1 - m) * var
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - mean.reshape(1, -1, 1, 1)) * mul.reshape(1, -1, 1, 1)
        return (y + self.bias.reshape(1, -1, 1, 1)).to(self.dtype)


def apply_batch_norm(model: nn.Module, params, batch_stats, x: torch.Tensor,
                     train: bool = True) -> tuple[torch.Tensor, dict]:
    """A ``norm_type="batch"`` model's forward with its running statistics:
    ``(logits, new_batch_stats)``, Flax's ``model.apply({"params": …,
    "batch_stats": …}, x, train=train, mutable=["batch_stats"])``.  In
    training the statistics are updated from the batch's; in evaluation
    they normalise and come back as they were.  ``params`` and
    ``batch_stats`` are ``{name: tensor}`` dicts (``BatchNorm_0.mean``)."""
    new: dict = {}
    token = _BATCH_NORM.set(_BatchNormCall(train, new))
    try:
        logits = torch.func.functional_call(model, {**params, **batch_stats}, (x,))
    finally:
        _BATCH_NORM.reset(token)
    return logits, (new if train else dict(batch_stats))


def batch_stats(model: nn.Module, device=None) -> dict[str, torch.Tensor]:
    """A BatchNorm model's initial running statistics, as Flax's
    ``model.init`` makes them: means 0, variances 1."""
    return {
        name: (torch.zeros if name.endswith(".mean") else torch.ones)(
            b.shape, dtype=torch.float32, device=device)
        for name, b in model.named_buffers()
    }


def _norm_factory(norm_type: str):
    """The norm module and its Flax name prefix for ``norm_type``."""
    if norm_type == "group":
        return GroupNorm, "GroupNorm"
    if norm_type == "batch":
        return BatchNorm, "BatchNorm"
    raise ValueError(f"unknown norm {norm_type!r}")


def _name_batch_norms(model: nn.Module) -> None:
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            module.path = name


class Dense(nn.Module):
    """Flax ``nn.Dense`` in float32; kernel ``[out, in]``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.kernel, self.bias)


class BasicBlock(nn.Module):
    """3×3 + 3×3 residual block (ResNet-20/32/44/56 family)."""

    def __init__(self, in_features: int, filters: int, strides: int,
                 dtype: torch.dtype = torch.float32, norm_type: str = "group"):
        super().__init__()
        norm, self.norm_prefix = _norm_factory(norm_type)
        self.Conv_0 = Conv(in_features, filters, 3, strides, dtype)
        self.add_module(f"{self.norm_prefix}_0", norm(filters, dtype=dtype))
        self.Conv_1 = Conv(filters, filters, 3, 1, dtype)
        self.add_module(f"{self.norm_prefix}_1", norm(filters, dtype=dtype))
        # Flax projects the residual when its shape differs from the output.
        if strides != 1 or in_features != filters:
            self.Conv_2 = Conv(in_features, filters, 1, strides, dtype)
            self.add_module(f"{self.norm_prefix}_2", norm(filters, dtype=dtype))
        else:
            self.Conv_2 = None

    def norm(self, i: int) -> nn.Module:
        return getattr(self, f"{self.norm_prefix}_{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm(0)(self.Conv_0(x)))
        y = self.norm(1)(self.Conv_1(y))
        residual = x if self.Conv_2 is None else self.norm(2)(self.Conv_2(x))
        return F.relu(y + residual)


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """Flax ``nn.max_pool(x, (window, window), (stride, stride), "SAME")``
    on NCHW: pad as ``SAME`` does, with −inf, then pool without padding."""
    ph = _same_pads(x.shape[-2], window, stride)
    pw = _same_pads(x.shape[-1], window, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 (strided) → 1×1 bottleneck (the ResNet-50 family), with a
    projected residual where the output's shape differs."""

    def __init__(self, in_features: int, filters: int, strides: int,
                 dtype: torch.dtype = torch.float32, norm_type: str = "group"):
        super().__init__()
        norm, self.norm_prefix = _norm_factory(norm_type)
        self.Conv_0 = Conv(in_features, filters, 1, 1, dtype)
        self.add_module(f"{self.norm_prefix}_0", norm(filters, dtype=dtype))
        self.Conv_1 = Conv(filters, filters, 3, strides, dtype)
        self.add_module(f"{self.norm_prefix}_1", norm(filters, dtype=dtype))
        self.Conv_2 = Conv(filters, 4 * filters, 1, 1, dtype)
        self.add_module(f"{self.norm_prefix}_2", norm(4 * filters, dtype=dtype))
        if strides != 1 or in_features != 4 * filters:
            self.Conv_3 = Conv(in_features, 4 * filters, 1, strides, dtype)
            self.add_module(f"{self.norm_prefix}_3", norm(4 * filters, dtype=dtype))
        else:
            self.Conv_3 = None

    norm = BasicBlock.norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm(0)(self.Conv_0(x)))
        y = F.relu(self.norm(1)(self.Conv_1(y)))
        y = self.norm(2)(self.Conv_2(y))
        residual = x if self.Conv_3 is None else self.norm(3)(self.Conv_3(x))
        return F.relu(y + residual)


def _start_from_key0(model: nn.Module, device) -> None:
    """Fill ``model``'s parameters with :func:`init` from ``prng.key(0)``."""
    with torch.no_grad():
        for name, value in init(model, prng.key(0), device).items():
            model.get_parameter(name).copy_(value)


class CifarResNet(nn.Module):
    """CIFAR-style ResNet: 3×3 stem, 3 stages of n blocks at 16/32/64."""

    def __init__(self, depth: int = 20, num_classes: int = 10,
                 norm_type: str = "group", dtype: torch.dtype = torch.float32):
        super().__init__()
        if (depth - 2) % 6 != 0:
            raise ValueError("CIFAR ResNet depth must be 6n+2")
        norm, self.norm_prefix = _norm_factory(norm_type)
        self.dtype = dtype
        n = (depth - 2) // 6
        self.Conv_0 = Conv(3, 16, 3, 1, dtype)
        self.add_module(f"{self.norm_prefix}_0", norm(16, dtype=dtype))
        in_features, index = 16, 0
        for stage, filters in enumerate((16, 32, 64)):
            for block in range(n):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(
                    f"BasicBlock_{index}",
                    BasicBlock(in_features, filters, strides, dtype, norm_type),
                )
                in_features, index = filters, index + 1
        self.n_blocks = index
        self.Dense_0 = Dense(64, num_classes)
        _name_batch_norms(self)
        _start_from_key0(self, None)

    norm = BasicBlock.norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: NHWC ``[B, H, W, 3]`` → logits ``[B, num_classes]``."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.norm(0)(self.Conv_0(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def ResNet20(**kw) -> CifarResNet:
    return CifarResNet(depth=20, **kw)


def ResNet56(**kw) -> CifarResNet:
    return CifarResNet(depth=56, **kw)


class ImageNetResNet(nn.Module):
    """ImageNet-style ResNet with bottleneck blocks (ResNet-50 by default):
    a 7×7 stride-2 stem, a SAME 3×3 stride-2 max-pool, four stages of
    bottleneck blocks at 64/128/256/512 filters (×4 out), the mean over
    H and W and a float32 Dense.  Built on ``device`` (the CPU by default),
    where its weights are drawn; on the meta device it holds no values, for
    ``functional_call`` with parameters from elsewhere."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), num_classes: int = 1000,
                 norm_type: str = "group", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        norm, self.norm_prefix = _norm_factory(norm_type)
        self.dtype = dtype
        with torch.device(device if device is not None else "cpu"):
            self.Conv_0 = Conv(3, 64, 7, 2, dtype)
            self.add_module(f"{self.norm_prefix}_0", norm(64, dtype=dtype))
            in_features, index = 64, 0
            for stage, (size, filters) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
                for block in range(size):
                    strides = 2 if stage > 0 and block == 0 else 1
                    self.add_module(
                        f"BottleneckBlock_{index}",
                        BottleneckBlock(in_features, filters, strides, dtype, norm_type),
                    )
                    in_features, index = 4 * filters, index + 1
            self.n_blocks = index
            self.Dense_0 = Dense(in_features, num_classes)
        _name_batch_norms(self)
        if torch.device(device if device is not None else "cpu").type != "meta":
            _start_from_key0(self, device)

    norm = BasicBlock.norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: NHWC ``[B, H, W, 3]`` → logits ``[B, num_classes]``."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.norm(0)(self.Conv_0(x)))
        x = max_pool_same(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def ResNet50(**kw) -> ImageNetResNet:
    return ImageNetResNet(stage_sizes=(3, 4, 6, 3), **kw)


def init(model: nn.Module, key: prng.Key, device=None) -> Leaves:
    """Fresh parameters for ``model`` as a new ``{name: tensor}`` dict on
    ``device`` (the CPU by default), the ones Flax's ``model.init(key, …)``
    makes: lecun-normal Conv and Dense kernels, each drawn from its own key
    in Flax's HWIO / ``[in, out]`` shape and laid out as the port's OIHW /
    ``[out, in]``; unit norm scales, zero biases.  The dict carries those
    kernels' axes back to the reference's layouts
    (:func:`dpwa_tpu_torch.convert.reference_axes`), for the wire.  The
    module itself is left as it is."""
    params = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        if leaf == "kernel":  # a Conv's or the Dense's first parameter
            shape = tuple(p.shape)
            flax_shape = (*shape[2:], shape[1], shape[0])  # OIHW -> HWIO; [out, in] -> [in, out]
            drawn = flax_rng.lecun_normal(flax_rng.param_key(key, path, 1), flax_shape, device)
            t = drawn.permute(3, 2, 0, 1) if drawn.dim() == 4 else drawn.t()
            params[name] = t.contiguous()
        elif leaf == "scale":
            params[name] = torch.ones(p.shape, dtype=torch.float32, device=device)
        else:
            params[name] = torch.zeros(p.shape, dtype=torch.float32, device=device)
    return Leaves(params, convert.reference_axes(params))
