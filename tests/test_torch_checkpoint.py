"""The port's checkpoints (``dpwa_tpu_torch.checkpoint``), scenario by scenario.

Each scenario of the reference's checkpoint tests that applies to a format
with no history is re-run against the port, on the CPU:
``tests/test_aux_subsystems.py:90-392`` (round trip, exact data-stream
resume, refusal without a sidecar, a re-save clearing a stale sidecar,
refusal of a stale step, the legacy unstamped sidecar, the stream's
parameter checks, the layout sidecar, resume across a wire-dtype change),
the stacked half of ``tests/test_stacked.py:211`` and ``:256``, and
``tests/test_recovery.py:525`` (a vandalised, truncated or corrupted newest
checkpoint skipped with a warning).  Restored states, and the steps taken
from them, are compared bit for bit: the port is deterministic on the CPU.

Left out: the pre-``loss`` format backfill (``test_aux_subsystems.py:122``;
the port's format has no older version), the cross-layout resume on the
SPMD mesh (``test_stacked.py:241-258``; the ICI transport is not ported),
and reading the reference's Orbax checkpoints (it needs JAX).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from dpwa_tpu_torch import checkpoint
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.data import PeerBatchStream, gaussian_blobs
from dpwa_tpu_torch.optim import AdamState, adam, lora_optimizer, sgd
from dpwa_tpu_torch.parallel import stacked
from dpwa_tpu_torch.train import softmax_cross_entropy_with_integer_labels
from dpwa_tpu_torch.utils.pytree import joint_flat


def _mlp_params(n, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"b1": (8,), "w1": (5, 8), "w2": (8, 3)}
    return {k: torch.from_numpy(rng.standard_normal((n, *s)).astype(np.float32) * 0.3)
            for k, s in shapes.items()}


def _mlp_loss(params, batch):
    x, y = batch
    h = torch.relu(x @ params["w1"] + params["b1"])
    return softmax_cross_entropy_with_integer_labels(h @ params["w2"], y).mean()


def _batches(n, steps, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.standard_normal((n, 4, 5)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 3, (n, 4)).astype(np.int32)))
            for _ in range(steps)]


def _setup(n=8, opt=None, steps=3, **cfg_kw):
    """A transport, optimizer, step and a state after ``steps`` steps."""
    t = stacked.StackedTransport(make_local_config(n, schedule="ring", **cfg_kw), device="cpu")
    opt = opt or sgd(0.1, momentum=0.9)
    step = stacked.make_stacked_train_step(_mlp_loss, opt, t)
    state = stacked.init_stacked_state(_mlp_params(n), opt, t)
    for batch in _batches(n, steps):
        state, _, _ = step(state, batch)
    return t, opt, step, state


def _fresh(t, opt, n=8, seed=99):
    """A ``like`` laid out as the saved state, holding other values."""
    return stacked.init_stacked_state(_mlp_params(n, seed), opt, t)


def _assert_states_equal(a, b):
    assert a.step == b.step
    assert torch.equal(a.params.flat, b.params.flat)
    assert torch.equal(a.clock, b.clock) and torch.equal(a.loss, b.loss)
    if isinstance(a.opt_state, AdamState):
        assert a.opt_state.count == b.opt_state.count
        assert torch.equal(a.opt_state.mu, b.opt_state.mu)
        assert torch.equal(a.opt_state.nu, b.opt_state.nu)
    else:
        assert torch.equal(a.opt_state, b.opt_state)


def _stream(n=4, batch_size=8, seed=7, n_per_class=40):
    x, y = gaussian_blobs(n_per_class=n_per_class, seed=2)
    return PeerBatchStream(x, y, n, batch_size=batch_size, seed=seed)


def test_checkpoint_roundtrip(tmp_path):
    t, opt, step, state = _setup()
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(ckpt, state)
    like = _fresh(t, opt)
    buffer = like.params.buffer
    restored = checkpoint.restore_checkpoint(ckpt, like=like)
    assert restored is like and restored.params.buffer is buffer  # copied in place
    assert restored.step == state.step == 3
    _assert_states_equal(restored, state)
    # Resume: the restored state continues the same exchange sequence.
    batch = _batches(8, 1, seed=5)[0]
    s1, _, i1 = step(state, batch)
    s2, _, i2 = step(restored, batch)
    assert torch.equal(i1.partner, i2.partner)
    _assert_states_equal(s1, s2)


def test_checkpoint_data_stream_resume_exact(tmp_path):
    stream = _stream()
    for _ in range(5):  # past a shard's epoch boundary
        next(stream)
    t = stacked.StackedTransport(make_local_config(4, schedule="ring"), device="cpu")
    state = stacked.init_stacked_state({"w": torch.ones(4, 3)}, sgd(0.1), t)
    ckpt = str(tmp_path / "ck")
    checkpoint.save_checkpoint(ckpt, state, data_stream=stream)
    want = [next(stream) for _ in range(6)]
    fresh = _stream()
    checkpoint.restore_checkpoint(ckpt, like=state, data_stream=fresh)
    assert fresh.batch_count == 5
    for (wx, wy), (gx, gy) in zip(want, (next(fresh) for _ in range(6))):
        np.testing.assert_array_equal(wx, gx)
        np.testing.assert_array_equal(wy, gy)


def _two_peer_state():
    t = stacked.StackedTransport(make_local_config(2, schedule="ring"), device="cpu")
    return stacked.init_stacked_state({"w": torch.ones(2, 3)}, sgd(0.1), t)


def test_checkpoint_without_data_sidecar_refuses_stream(tmp_path):
    state = _two_peer_state()
    ckpt = str(tmp_path / "ck")
    checkpoint.save_checkpoint(ckpt, state)
    with pytest.raises(FileNotFoundError, match="data-stream sidecar"):
        checkpoint.restore_checkpoint(ckpt, like=state, data_stream=_stream(2, 4, 0, 20))
    assert checkpoint.restore_checkpoint(ckpt, like=state).step == 0


def test_checkpoint_resave_clears_stale_data_sidecar(tmp_path):
    stream = _stream(2, 4, 0, 20)
    next(stream)
    state = _two_peer_state()
    ckpt = str(tmp_path / "ck")
    checkpoint.save_checkpoint(ckpt, state, data_stream=stream)
    checkpoint.save_checkpoint(ckpt, state)  # re-save, no stream
    with pytest.raises(FileNotFoundError, match="data-stream sidecar"):
        checkpoint.restore_checkpoint(ckpt, like=state, data_stream=_stream(2, 4, 0, 20))


def test_checkpoint_refuses_stale_step_sidecar(tmp_path):
    state = _two_peer_state()
    ckpt = str(tmp_path / "ck")
    checkpoint.save_checkpoint(ckpt, state, data_stream=_stream(2, 4, 0, 20))
    sidecar = checkpoint._data_state_path(ckpt)
    with open(sidecar) as f:
        payload = json.load(f)
    assert payload["ckpt_step"] == 0
    payload["ckpt_step"] = 99  # a sidecar from another save
    with open(sidecar, "w") as f:
        json.dump(payload, f)
    state.params.flat.fill_(7.0)
    with pytest.raises(ValueError, match="step 99"):
        checkpoint.restore_checkpoint(ckpt, like=state, data_stream=_stream(2, 4, 0, 20))
    assert bool((state.params.flat == 7.0).all())  # refused before any copy
    assert checkpoint.validate_checkpoint(ckpt, data_stream=True).startswith("data-stream sidecar")
    checkpoint.restore_checkpoint(ckpt, like=state)  # no stream: unaffected


def test_checkpoint_legacy_sidecar_without_stamp(tmp_path):
    stream = _stream(2, 4, 0, 20)
    next(stream)
    state = _two_peer_state()
    ckpt = str(tmp_path / "ck")
    checkpoint.save_checkpoint(ckpt, state, data_stream=stream)
    sidecar = checkpoint._data_state_path(ckpt)
    with open(sidecar) as f:
        payload = json.load(f)
    with open(sidecar, "w") as f:
        json.dump(payload["data"], f)  # the unwrapped, unstamped form
    fresh = _stream(2, 4, 0, 20)
    checkpoint.restore_checkpoint(ckpt, like=state, data_stream=fresh)
    assert fresh.batch_count == 1
    # A save over a legacy sidecar removes it first (it cannot be checked).
    checkpoint.save_checkpoint(ckpt, state)
    assert not os.path.exists(sidecar)


def test_data_stream_state_rejects_mismatched_parameters():
    x, y = gaussian_blobs(n_per_class=20)
    stream = PeerBatchStream(x, y, 4, batch_size=8, seed=1)
    next(stream)
    snap = stream.state_dict()
    with pytest.raises(ValueError, match="batch_size"):
        PeerBatchStream(x, y, 4, batch_size=16, seed=1).load_state_dict(snap)
    with pytest.raises(ValueError, match="n_peers"):
        PeerBatchStream(x, y, 2, batch_size=8, seed=1).load_state_dict(snap)


def test_checkpoint_layout_sidecar_restores_right_class(tmp_path):
    """Without ``like``: the class the layout sidecar names, on the CPU, the
    FlatParams rebuilt with its column order (a masked optimizer's leaves
    leading)."""
    t = stacked.StackedTransport(make_local_config(2), device="cpu")
    lead = lambda name: name.startswith("w")
    opt = lora_optimizer(adam(1e-2), lead)
    state = stacked.init_stacked_state(_mlp_params(2), opt, t)
    state, _, _ = stacked.make_stacked_train_step(_mlp_loss, opt, t)(state, _batches(2, 1)[0])
    ckpt = str(tmp_path / "ck")
    checkpoint.save_checkpoint(ckpt, state)
    with open(checkpoint._layout_path(ckpt)) as f:
        assert json.load(f) == {"layout": "StackedTrainState"}
    bare = checkpoint.restore_checkpoint(ckpt)
    assert type(bare) is stacked.StackedTrainState and bare.step == 1
    assert bare.params.offsets == state.params.offsets
    assert bare.params.column_ranges(lead) == [(0, 5 * 8 + 8 * 3)]
    _assert_states_equal(bare, state)
    assert bare.params.buffer.device.type == "cpu" and isinstance(bare.opt_state, AdamState)


def test_checkpoint_resume_across_wire_dtype_change(tmp_path):
    """A checkpoint saved under the f32 wire restores into an int8-wire
    transport's state (the wire is stateless) and training continues on the
    same schedule sequence."""
    t32, opt, step32, state = _setup()
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(ckpt, state)
    t8 = stacked.StackedTransport(
        make_local_config(8, schedule="ring", wire_dtype="int8"), device="cpu")
    restored = checkpoint.restore_checkpoint(ckpt, like=_fresh(t8, opt))
    step8 = stacked.make_stacked_train_step(_mlp_loss, opt, t8)
    batch = _batches(8, 1, seed=5)[0]
    s2, losses, i2 = step8(restored, batch)
    _, _, i1 = step32(state, batch)
    assert torch.equal(i1.partner, i2.partner)
    assert s2.step == 4 and bool(torch.isfinite(losses).all())


def test_stacked_checkpoint_roundtrip_with_adam_and_model_state(tmp_path):
    """The stacked half of ``tests/test_stacked.py:211`` (Adam, 3 steps),
    with model state in the parameters' buffer: restored bit for bit into
    ``like``'s buffers, which still share one allocation, and the next step
    from the restored state equals the next step from the saved one."""
    n = 8
    t = stacked.StackedTransport(make_local_config(n, schedule="ring"), device="cpu")
    opt = adam(1e-2)

    def loss_fn(params, model_state, batch):
        new = {"m": 0.9 * model_state["m"] + 0.1 * batch[0].mean(dim=(0, 1))}
        return _mlp_loss(params, batch), new

    step = stacked.make_stacked_train_step(loss_fn, opt, t, with_state=True)
    init = lambda seed: stacked.init_stacked_state(
        _mlp_params(n, seed), opt, t, {"m": torch.full((n, 5), float(seed))})
    state = init(0)
    for batch in _batches(n, 3):
        state, _, _ = step(state, batch)
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(ckpt, state)
    restored = checkpoint.restore_checkpoint(ckpt, like=init(99))
    assert isinstance(restored, stacked.StackedTrainState) and restored.step == 3
    _assert_states_equal(restored, state)
    assert torch.equal(restored.model_state.flat, state.model_state.flat)
    joint_flat(restored.params, restored.model_state)  # still one buffer
    bare = checkpoint.restore_checkpoint(ckpt)
    assert torch.equal(bare.model_state.flat, state.model_state.flat)
    batch = _batches(n, 1, seed=42)[0]
    s1, _, _ = step(state, batch)  # both steps update their state in place
    s2, _, _ = step(restored, batch)
    _assert_states_equal(s1, s2)
    assert torch.equal(s1.model_state.flat, s2.model_state.flat)


def test_restore_refuses_a_layout_mismatch_before_copying(tmp_path):
    t, opt, _, state = _setup()
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(ckpt, state)
    other = stacked.init_stacked_state(
        {**_mlp_params(8), "w2": torch.zeros(8, 8, 4)}, opt, t)
    before = other.params.flat.clone()
    with pytest.raises(ValueError, match="layout"):
        checkpoint.restore_checkpoint(ckpt, like=other)
    assert torch.equal(other.params.flat, before)
    with pytest.raises(ValueError, match="record type|tensor"):
        checkpoint.restore_checkpoint(ckpt, like=stacked.init_stacked_state(
            _mlp_params(8), adam(1e-2), t))


def test_validate_and_fallback_checkpoint(tmp_path):
    """A vandalised, truncated or corrupted newest checkpoint:
    ``restore_latest_valid`` warns and falls back to the older sound one;
    ``validate_checkpoint`` names the fault without reading tensor data."""
    t, opt, _, state = _setup(steps=1)
    old, new = str(tmp_path / "c1"), str(tmp_path / "c2")
    checkpoint.save_checkpoint(old, state)
    checkpoint.save_checkpoint(new, state)
    assert checkpoint.validate_checkpoint(old) is None
    assert checkpoint.validate_checkpoint(str(tmp_path / "nope")) == "not a directory"
    tensors = os.path.join(new, checkpoint.TENSORS)
    data = open(tensors, "rb").read()

    # Truncated: the size disagrees with the manifest.
    with open(tensors, "wb") as f:
        f.write(data[: len(data) // 2])
    assert "bytes" in checkpoint.validate_checkpoint(new)
    with pytest.warns(UserWarning, match="falling back"):
        restored = checkpoint.restore_latest_valid([old, new], like=_fresh(t, opt))
    _assert_states_equal(restored, state)

    # Corrupted in place: sound to the cheap check, refused by the CRC.
    flipped = bytearray(data)
    flipped[len(data) - 64] ^= 0xFF
    with open(tensors, "wb") as f:
        f.write(bytes(flipped))
    assert checkpoint.validate_checkpoint(new) is None
    with pytest.raises(ValueError, match="CRC"):
        checkpoint.restore_checkpoint(new, like=_fresh(t, opt))
    with pytest.warns(UserWarning, match="restore failed"):
        checkpoint.restore_latest_valid([old, new], like=_fresh(t, opt))

    # Vandalised as a mid-write crash would leave it: nothing inside.
    for entry in os.listdir(new):
        p = os.path.join(new, entry)
        shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
    assert checkpoint.validate_checkpoint(new) is not None
    with pytest.warns(UserWarning, match="falling back"):
        restored = checkpoint.restore_latest_valid([old, new], like=_fresh(t, opt))
    assert restored.step == state.step
    with pytest.raises(FileNotFoundError), pytest.warns(UserWarning):
        checkpoint.restore_latest_valid([new])
