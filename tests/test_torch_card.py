"""The port's CUDA kernels and train step on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the reference package, so it also runs on a machine that
has only PyTorch; there, skip the repository's ``conftest.py`` (which sets
up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

The kernels are held bit for bit against their plain versions on a CPU copy
of the same inputs; the train step on the card against the same steps on
the CPU (TF32 off).
"""

import numpy as np
import pytest
import torch

from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.models import resnet
from dpwa_tpu_torch.ops import merge
from dpwa_tpu_torch.optim import sgd
from dpwa_tpu_torch.parallel import stacked
from dpwa_tpu_torch.train import (
    init_params_per_peer,
    softmax_cross_entropy_with_integer_labels,
)

N = 8
RING_ODD = np.array([7, 2, 1, 4, 3, 6, 5, 0])
WITH_FIXED = np.array([1, 0, 2, 3, 5, 4, 6, 7])

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("wire_bf16", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "padded", "offset"])
def test_kernels_bit_equal_to_plain(cuda_device, layout, wire_bf16):
    d = 272474
    gen = torch.Generator().manual_seed(4)
    base = torch.randn(N, d, generator=gen)
    alpha = torch.rand(N, generator=gen)

    def on_card(cpu):
        if layout == "contiguous":
            return cpu.to(cuda_device)
        lead = 3 if layout == "offset" else 0
        buf = torch.zeros(N, d + lead + 29, device=cuda_device)
        view = buf[:, lead:lead + d]
        view.copy_(cpu)
        return view

    merge.reset_launch_counts()
    left, right = (torch.from_numpy(v) for v in merge.involution_pairs(WITH_FIXED, pad_to=4))
    x = on_card(base)
    merge.pair_merge_(x, left.to(cuda_device), right.to(cuda_device),
                      alpha.to(cuda_device), wire_bf16=wire_bf16)
    want = merge.torch_pair_merge_(base.clone(), left, right, alpha, wire_bf16=wire_bf16)
    assert torch.equal(x.cpu(), want)
    partner = torch.from_numpy(RING_ODD.astype(np.int32))
    got = merge.gather_merge(on_card(base), partner.to(cuda_device),
                             alpha.to(cuda_device), wire_bf16=wire_bf16)
    want = merge.torch_pairwise_merge(base, partner, alpha, wire_bf16=wire_bf16)
    assert torch.equal(got.cpu(), want)
    assert merge.pair_merge_.launches == 1 and merge.gather_merge.launches == 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device)
    idx = torch.tensor([0, 2], dtype=torch.int32, device=cuda_device)
    alpha = torch.zeros(4, device=cuda_device)
    with pytest.raises(TypeError):
        merge.pair_merge_(x.double(), idx, idx + 1, alpha.double())
    with pytest.raises(ValueError):
        merge.pair_merge_(x.t(), idx, idx + 1, alpha)
    with pytest.raises(ValueError):
        merge.pair_merge_(x, idx.long(), idx + 1, alpha)
    with pytest.raises(ValueError):
        merge.gather_merge(x, idx, alpha)
    with pytest.raises(ValueError):
        merge.gather_merge(x, idx.cpu(), alpha)
    with pytest.raises(ValueError, match="overlap"):
        merge.pair_merge_(torch.zeros(1, 8, device=cuda_device).expand(4, 8), idx, idx + 1, alpha)
    partner = torch.arange(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="storage"):
        merge.gather_merge(x, partner, alpha, out=x)


@pytest.mark.parametrize("mode", ["pairwise", "pull"])
def test_train_step_on_card_matches_cpu(cuda_device, mode):
    """Three steps of a 4-peer ResNet-8 on the card (every exchange through
    B1 or B2) and on the CPU (the plain merges), from the same parameters
    and batches.  TF32 is off, so only the order of sums differs: losses
    rtol 1e-4, parameters rtol 1e-3 / atol 1e-4."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, steps = 4, 3
    rng = np.random.default_rng(0)
    batches = [
        (torch.from_numpy(rng.random((n, 8, 32, 32, 3), np.float32)),
         torch.from_numpy(rng.integers(0, 10, (n, 8)).astype(np.int32)))
        for _ in range(steps)
    ]
    results = []
    for device in ("cpu", cuda_device):
        model = resnet.CifarResNet(depth=8).to(device)
        cfg = make_local_config(n, mode=mode, interpolation="loss", factor=0.9)
        t = stacked.StackedTransport(cfg, device=device)
        opt = sgd(0.1, momentum=0.9)

        def loss_fn(params, batch):
            logits = torch.func.functional_call(model, params, (batch[0],))
            return softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean()

        params = init_params_per_peer(
            lambda g: resnet.init(model, g), torch.Generator().manual_seed(0), n, device
        )
        state = stacked.init_stacked_state(params, opt, t)
        step = stacked.make_stacked_train_step(loss_fn, opt, t)
        merge.reset_launch_counts()
        losses = []
        for x, y in batches:
            state, loss, _ = step(state, (x.to(device), y.to(device)))
            losses.append(loss.cpu())
        launches = merge.pair_merge_.launches + merge.gather_merge.launches
        results.append((torch.stack(losses), state.params.flat.cpu(), launches))
    (cpu_l, cpu_p, cpu_launches), (gpu_l, gpu_p, gpu_launches) = results
    assert cpu_launches == 0 and gpu_launches == steps
    torch.testing.assert_close(gpu_l, cpu_l, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gpu_p, cpu_p, rtol=1e-3, atol=1e-4)
