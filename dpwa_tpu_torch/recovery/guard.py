"""The pre-merge payload guard (the port of
:func:`dpwa_tpu.recovery.guard.validate_payload`).

The TCP transport runs it on every fetched frame while ``recovery.enabled``
(the default), before the merge: a well-formed frame that carries a sick
replica (non-finite values, an exploded or vanished norm, an insane loss)
is not merged and the fetch is classified ``poisoned``.  The checks run
where the frame lies, the card included, in float64 for the norm as the
reference's; only two scalars come back to the host.  The norm's sum runs
in another order than numpy's, so a frame whose norm sits within float64
rounding of a bound may be judged differently; nothing else differs.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from dpwa_tpu_torch.config import RecoveryConfig


def payload_checks(vec) -> tuple[bool, float]:
    """``(all finite, float64 L2 norm)`` of ``vec`` (a tensor on any
    device, or a numpy array), with one readback."""
    v = torch.from_numpy(np.ascontiguousarray(vec)) if isinstance(vec, np.ndarray) else vec
    v = v.reshape(-1)
    finite = torch.isfinite(v).all().to(torch.float64)
    norm = torch.linalg.vector_norm(v, dtype=torch.float64)
    ok, value = torch.stack([finite, norm]).tolist()
    return bool(ok), float(value)


def validate_payload(
    vec,
    loss: float,
    config: RecoveryConfig,
    local_norm: Optional[float] = None,
) -> Optional[str]:
    """None if ``(vec, loss)`` is a sane replica, else the violation, one of
    the reference's strings: ``nonfinite_params`` | ``param_norm`` |
    ``zero_energy`` | ``nonfinite_loss`` | ``loss_bound``.

    ``vec`` is the frame's payload (float32 or bf16, checked in float64);
    ``local_norm`` the receiver's own replica norm, against which a remote
    below ``min_param_norm_ratio`` of it is ``zero_energy``."""
    finite, norm = payload_checks(vec)
    if not finite:
        return "nonfinite_params"
    if norm > config.max_param_norm:
        return "param_norm"
    if (
        config.min_param_norm_ratio > 0.0
        and local_norm is not None
        and local_norm > 0.0
        and norm < config.min_param_norm_ratio * local_norm
    ):
        return "zero_energy"
    l = float(loss)
    if math.isnan(l) or math.isinf(l):
        return "nonfinite_loss"
    if abs(l) > config.max_loss:
        return "loss_bound"
    return None
