"""The merge of the TCP transport (the port of
:class:`dpwa_tpu.device.engine.MergeEngine`'s dense and bf16 families).

Both merges are one launch of B2 (:func:`dpwa_tpu_torch.ops.merge.
gather_merge`) over a single row ``[1, d]``: the local replica as ``x``,
the landed frame as the wire buffer ``w`` (float32, or bf16 as it came off
the wire, widened in the kernel), out of place; the caller adopts the
output (``DeviceReplica.swap``).  On the CPU the same call runs B2's plain
version, which is the host path of ``TcpTransport.exchange``.  B2's own
launch count (``gather_merge.launches``) counts the merges.

The arithmetic is the reference's TCP merge: ``native.merge_out``'s
``(1-α)·x + α·y`` as g++ contracts it, and the device engine's XLA lerp,
both one fused multiply-add of the local product, ``fma(1-α, x, α·y)``
(``tests/test_torch_tcp.py`` pins it at α ≠ 0.5 against both).  That is
B2's int8-wire form; a bf16 frame takes its bf16 form, whose rounding of
``y`` to bf16 is exact on a bf16 frame.
"""

from __future__ import annotations

import torch

from dpwa_tpu_torch.ops.merge import gather_merge

# B2's forms (ops.merge.WIRES) that compute the reference's TCP merge.
F32_FORM = "int8"  # fma(1-α, x, α·y) on a float32 frame
BF16_FORM = "bf16"  # the same on a bf16 frame


def merge(local: torch.Tensor, remote: torch.Tensor, alpha: float) -> torch.Tensor:
    """``(1-α)·local + α·remote`` as a new flat float32 tensor on
    ``local``'s device; ``remote`` is the landed frame (float32 or bf16,
    same length and device)."""
    if remote.shape != local.shape or remote.device != local.device:
        raise ValueError(
            f"frame {tuple(remote.shape)} on {remote.device} does not match the "
            f"replica {tuple(local.shape)} on {local.device}"
        )
    form = BF16_FORM if remote.dtype == torch.bfloat16 else F32_FORM
    a = torch.full((1,), alpha, dtype=torch.float32, device=local.device)
    partner = torch.zeros(1, dtype=torch.int32, device=local.device)
    return gather_merge(local[None], partner, a, wire=form, w=remote[None])[0]
