"""MNIST-class ConvNets (the port of :mod:`dpwa_tpu.models.mnist`).

:class:`ConvNet` takes 28×28×1 MNIST; :class:`SmallNet`, its scaled-down
sibling, the 8×8 digits.  As in :mod:`dpwa_tpu_torch.models.resnet`, the
public call takes NHWC, a parameter's name is its Flax key path
(``Conv_0.kernel``, ``Dense_1.bias``), conv kernels are OIHW and Dense
kernels ``[out, in]``, so :func:`dpwa_tpu_torch.convert.flax_to_torch`
carries the reference's parameters across.  What matches Flax:

- ``Conv`` pads ``SAME`` and adds a bias; ``max_pool`` takes 2×2 windows
  at stride 2 with no padding (``VALID``);
- the flattening before ``Dense_0`` runs over NHWC, as the reference's
  ``x.reshape((B, -1))``: ``Dense_0``'s inputs come in (h, w, c) order, so
  the model goes back from its NCHW inside to NHWC before it flattens.

:func:`init` draws the weights Flax's ``model.init`` makes from a key:
lecun-normal kernels, zero biases.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dpwa_tpu_torch.models import resnet

init = resnet.init  # lecun-normal kernels from their Flax keys, zero biases


class Conv(resnet.Conv):
    """Flax ``nn.Conv`` with its bias: SAME padding, kernel OIHW."""

    def __init__(self, in_features: int, features: int, kernel_size: int):
        super().__init__(in_features, features, kernel_size)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x) + self.bias.reshape(1, -1, 1, 1)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``[B, C, H, W]`` flattened in the reference's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class ConvNet(nn.Module):
    """Conv(32) → Conv(64) → 2×2 max-pool → Dense(128) → Dense(classes),
    for 28×28×1 inputs (1,625,866 parameters)."""

    def __init__(self, num_classes: int = 10, image_size: int = 28):
        super().__init__()
        self.Conv_0 = Conv(1, 32, 3)
        self.Conv_1 = Conv(32, 64, 3)
        self.Dense_0 = resnet.Dense((image_size // 2) ** 2 * 64, 128)
        self.Dense_1 = resnet.Dense(128, num_classes)
        resnet._start_from_key0(self, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: NHWC ``[B, H, W, 1]`` → logits ``[B, num_classes]``."""
        x = F.relu(self.Conv_0(x.permute(0, 3, 1, 2)))
        x = F.relu(self.Conv_1(x))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.Dense_0(_flatten_nhwc(x)))
        return self.Dense_1(x)


class SmallNet(nn.Module):
    """Conv(16) → Dense(64) → Dense(classes), for the 8×8 digits (66,410
    parameters)."""

    def __init__(self, num_classes: int = 10, image_size: int = 8):
        super().__init__()
        self.Conv_0 = Conv(1, 16, 3)
        self.Dense_0 = resnet.Dense(image_size**2 * 16, 64)
        self.Dense_1 = resnet.Dense(64, num_classes)
        resnet._start_from_key0(self, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: NHWC ``[B, H, W, 1]`` → logits ``[B, num_classes]``."""
        x = F.relu(self.Conv_0(x.permute(0, 3, 1, 2)))
        x = F.relu(self.Dense_0(_flatten_nhwc(x)))
        return self.Dense_1(x)


def build_model(image_shape) -> nn.Module:
    """The reference example's choice: :class:`ConvNet` for 28×28 and
    larger images, :class:`SmallNet` below."""
    return ConvNet() if image_shape[0] >= 28 else SmallNet()
