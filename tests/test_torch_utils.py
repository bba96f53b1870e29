"""The port's data streams, optimizer and flat parameters against the
reference: the same batches from the same seed, optax's SGD update math,
the reference's per-exchange wire bytes."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpwa_tpu import data as ref_data
from dpwa_tpu.utils import pytree as ref_pytree
from dpwa_tpu_torch import data
from dpwa_tpu_torch.optim import sgd
from dpwa_tpu_torch.utils import pytree
from dpwa_tpu_torch.utils.devices import resolve_device


def test_peer_batches_equal_reference_and_resume():
    rng = np.random.default_rng(0)
    x = rng.random((103, 4, 4, 3), np.float32)
    y = rng.integers(0, 10, 103).astype(np.int32)
    ref = ref_data.peer_batches(x, y, 4, 7, seed=3)
    port = data.peer_batches(x, y, 4, 7, seed=3)
    for _ in range(9):  # crosses several per-peer epochs (25 samples each)
        (rx, ry), (px, py) = next(ref), next(port)
        np.testing.assert_array_equal(px, rx)
        np.testing.assert_array_equal(py, ry)
    snap = port.state_dict()
    ahead = [next(port) for _ in range(3)]
    resumed = data.peer_batches(x, y, 4, 7, seed=3)
    resumed.load_state_dict(snap)
    for (ax, ay), (bx, by) in zip(ahead, (next(resumed) for _ in range(3))):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)
    with pytest.raises(ValueError, match="batch_size"):
        data.peer_batches(x, y, 4, 8, seed=3).load_state_dict(snap)


def test_device_batches_stage_every_batch_in_order():
    batches = [(np.full((2, 3), i, np.float32), np.full((2,), i, np.int32)) for i in range(5)]
    staged = list(data.device_batches(iter(batches), "cpu", size=2))
    assert len(staged) == 5
    for i, (bx, by) in enumerate(staged):
        assert bx.dtype == torch.float32 and by.dtype == torch.int32
        assert torch.equal(bx, torch.full((2, 3), float(i)))


@pytest.mark.parametrize("momentum", [None, 0.9])
def test_sgd_matches_optax(momentum):
    rng = np.random.default_rng(1)
    p = rng.standard_normal((3, 50)).astype(np.float32)
    grads = [rng.standard_normal((3, 50)).astype(np.float32) for _ in range(4)]
    ref_opt = optax.sgd(0.1, momentum=momentum)
    ref_p, ref_s = jnp.asarray(p), ref_opt.init(jnp.asarray(p))
    opt = sgd(0.1, momentum=momentum)
    port_p = torch.from_numpy(p.copy())
    state = opt.init(port_p)
    for g in grads:
        upd, ref_s = ref_opt.update(jnp.asarray(g), ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, upd)
        port_p.add_(opt.update_(torch.from_numpy(g), state))
    np.testing.assert_allclose(port_p.numpy(), np.asarray(ref_p), rtol=1e-6, atol=1e-7)


def _tree():
    return {
        "b.kernel": torch.arange(6, dtype=torch.float32).reshape(1, 2, 3),
        "a.bias": torch.ones(1, 5),
        "a.kernel": torch.full((1, 2, 2), 2.0),
        "steps": torch.zeros(1, 3, dtype=torch.int32),
    }


def test_flat_params_views_layout_and_ranges():
    flat = pytree.FlatParams.stack({k: v.float() for k, v in _tree().items()})
    assert flat.names == ("a.bias", "a.kernel", "b.kernel", "steps")
    assert flat.size == 5 + 4 + 6 + 3 and flat.ld == 32
    assert flat.buffer.is_contiguous() and flat.flat.shape == (1, 18)
    views = flat.views()
    assert torch.equal(views["b.kernel"], _tree()["b.kernel"])
    views["a.kernel"].mul_(3.0)  # views alias the buffer
    assert torch.equal(flat.flat[0, 5:9], torch.full((4,), 6.0))
    assert flat.column_ranges() == [(0, 18)]
    assert flat.column_ranges(lambda n: n.endswith("kernel")) == [(5, 15)]
    assert flat.column_ranges(lambda n: n != "a.kernel") == [(0, 5), (9, 18)]
    packed = flat.pack({k: v.float() for k, v in _tree().items()})
    assert packed.shape == flat.flat.shape
    assert torch.equal(packed[0, 9:15], torch.arange(6.0))
    with pytest.raises(ValueError, match="leaf order"):
        pytree.FlatParams(["b", "a"], [(1,), (1,)], 1)


def test_flat_params_first_places_leaves_ahead_and_adds_by_predicate():
    """``first`` puts the leaves it selects in the leading columns (views
    stay in leaf order); :meth:`pack` and :meth:`add_` work in column order
    on the selected leaves and leave the rest bit-identical."""
    tree = {k: v.float() for k, v in _tree().items()}
    pred = lambda n: n.endswith("kernel")
    flat = pytree.FlatParams.stack(tree, first=pred)
    assert list(flat.views()) == ["a.bias", "a.kernel", "b.kernel", "steps"]
    assert flat.column_ranges(pred) == [(0, 10)]
    assert flat.column_ranges(lambda n: not pred(n)) == [(10, 18)]
    assert flat.column_ranges() == [(0, 18)]
    packed = flat.pack(tree, pred)
    assert torch.equal(packed[0], torch.cat([torch.full((4,), 2.0), torch.arange(6.0)]))
    before = flat.flat.clone()
    flat.add_(torch.ones(1, 10), pred)
    assert torch.equal(flat.flat[:, :10], before[:, :10] + 1.0)
    assert torch.equal(flat.flat[:, 10:], before[:, 10:])
    assert torch.equal(flat.views()["b.kernel"], tree["b.kernel"] + 1.0)
    with pytest.raises(ValueError, match="columns"):
        flat.add_(torch.ones(1, 9), pred)


def test_flat_params_swap_adopts_the_spare_buffer():
    flat = pytree.FlatParams.stack({k: v.float() for k, v in _tree().items()})
    with pytest.raises(RuntimeError, match="spare"):
        flat.swap()
    old = flat.buffer
    spare = flat.spare_flat()
    assert spare.shape == flat.flat.shape and spare.stride() == flat.flat.stride()
    spare.copy_(flat.flat * 2.0)
    flat.swap()
    assert torch.equal(flat.views()["b.kernel"], 2.0 * _tree()["b.kernel"])
    assert torch.equal(flat.buffer[:, flat.size:], torch.zeros(1, 14))  # pads stay 0
    assert flat.spare_flat().data_ptr() == old.data_ptr()  # the old buffer is the spare


def test_partition_combine_and_wire_bytes_match_reference():
    tree = {k: v[0] for k, v in _tree().items()}
    jtree = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    pred = lambda name: name.startswith("a.")
    sel, rest = pytree.partition(tree, pred)
    ref_sel, ref_rest = ref_pytree.partition(jtree, pred)
    assert {k for k, v in sel.items() if v is not None} == {
        k for k, v in ref_sel.items() if v is not None
    }
    assert {k for k, v in rest.items() if v is not None} == {
        k for k, v in ref_rest.items() if v is not None
    }
    back = pytree.combine(sel, rest)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    with pytest.raises(ValueError):
        pytree.combine(sel, sel)
    for wire in ("f32", "bf16", "int8"):
        assert pytree.tree_wire_bytes(tree, wire) == ref_pytree.tree_wire_bytes(jtree, wire)
    with pytest.raises(ValueError):
        pytree.tree_wire_bytes(tree, "int4")


def test_resolve_device_never_picks_the_cpu_by_itself():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_breakdown_counts_each_part_by_its_launches_on_the_host():
    """``trace.breakdown`` on a hand-made trace: the busy time is the union
    of the kernels' intervals, and each part of the step (a
    ``record_function`` range on the host) gets the kernels its operations
    launched inside its range — also those of another thread (the
    backward's), and not the part's own range on the card's timeline."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from dpwa_tpu_torch.utils import trace

    def event(name, device, start, end, kernels=()):
        rng = SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
        return SimpleNamespace(name=name, device_type=device, time_range=rng,
                               kernels=[SimpleNamespace(duration=d) for d in kernels])

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        event("step.grads", cpu, 0, 100), event("step.optimizer", cpu, 100, 150),
        event("aten::mm", cpu, 10, 12, [30]),  # the forward, main thread
        event("MmBackward0", cpu, 60, 61, [50]),  # the backward's thread, inside grads
        event("aten::add_", cpu, 120, 121, [7]),
        event("aten::copy_", cpu, 200, 201, [3]),  # outside every part
        event("step.grads", cuda, 1000, 1040),  # the annotation on the card
        event("gemm_kernel", cuda, 1000, 1030), event("gemm_kernel", cuda, 1030, 1080),
        event("add_kernel", cuda, 1100, 1107), event("copy_kernel", cuda, 1105, 1108),
    ]
    out = trace.breakdown(SimpleNamespace(events=lambda: events), wall_s=200e-6, steps=1)
    assert out["device_busy_ms_per_step"] == 88e-3
    assert out["device_ops_per_step"] == 4
    assert out["grads_ms_per_step"] == 80e-3 and out["optimizer_ms_per_step"] == 7e-3
    assert out["exchange_ms_per_step"] == 0.0
    assert out["gemm_ms_per_step"] == 80e-3
    assert [t["name"] for t in out["top"]] == ["gemm_kernel", "add_kernel", "copy_kernel"]
