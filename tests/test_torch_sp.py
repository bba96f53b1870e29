"""The port's sequence-parallel Llama and train step against the reference.

The reference runs its ``(peers, sp)`` mesh on the 8-device CPU mesh; the
port runs the peers stacked and the sp ranks as a virtual axis, on the CPU.
The same Flax parameters (``lora_b`` drawn non-zero) and the same numpy
batches go to both.  Logits agree at rtol 1e-4 / atol 1e-5 (float32, as
``tests/test_torch_llama.py``); three train steps at the reference's own
tolerances (``tests/test_sp_train.py:111-117``: losses rtol 2e-4 / atol
2e-5, parameters rtol 3e-3 / atol 3e-4), with partners bit-equal and the
frozen leaves bit-identical.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dpwa_tpu.config import make_local_config as ref_config
from dpwa_tpu.models import llama as ref_llama
from dpwa_tpu.ops.zigzag_ring import zigzag_shard as ref_zigzag_shard
from dpwa_tpu.parallel.ici import IciTransport
from dpwa_tpu.train import init_params_per_peer as ref_init_per_peer
from dpwa_tpu.train_sp import (
    init_gossip_sp_state as ref_init_sp_state,
    make_gossip_sp_train_step as ref_make_sp_step,
    make_sp_mesh,
    sp_batch_sharding,
)
from dpwa_tpu.utils.compat import shard_map
from dpwa_tpu_torch import convert
from dpwa_tpu_torch.config import make_local_config
from dpwa_tpu_torch.models import llama
from dpwa_tpu_torch.ops import flash_ring
from dpwa_tpu_torch.ops.zigzag_ring import zigzag_positions
from dpwa_tpu_torch.optim import adam, lora_optimizer
from dpwa_tpu_torch.parallel import stacked, virtual_axis
from dpwa_tpu_torch.train import softmax_cross_entropy_with_integer_labels
from dpwa_tpu_torch import train_sp
from dpwa_tpu_torch.utils import prng

REPO = pathlib.Path(__file__).resolve().parents[1]
N_PEERS, B, T = 2, 2, 32
BASE = dict(
    vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=64, max_seq_len=64, lora_rank=4,
)
# The train-step cases trace the reference's whole sp step, so one layer.
STEP_BASE = dict(BASE, n_layers=1)
# (strategy, layout, attn_impl): the ring's flash path (B3/B4's plain
# versions here), its einsum hop, the zigzag panels, and Ulysses.
VARIANTS = {
    "ring_flash": ("ring", "contiguous", "flash"),
    "ring_einsum": ("ring", "contiguous", "auto"),
    "zigzag": ("ring", "zigzag", "auto"),
    "a2a": ("a2a", "contiguous", "auto"),
}



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side at these sizes runs on one thread: the parallel
    tier-1 run shares the cores with timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _sp_kw(variant):
    strategy, layout, impl = VARIANTS[variant]
    return dict(sp_axis="sp", sp_strategy=strategy, sp_layout=layout, attn_impl=impl)


def _stacked_flax_params(seed, base=BASE):
    """Flax init for every peer, each ``lora_b`` replaced by N(0, 0.1²)."""
    model = ref_llama.Llama(ref_llama.LlamaConfig(**base))
    params = ref_init_per_peer(
        lambda k: model.init(k, jnp.zeros((1, 8), jnp.int32)), jax.random.key(seed), N_PEERS
    )
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(rng.normal(0, 0.1, v.shape), jnp.float32)
        if "lora_b" in jax.tree_util.keystr(path) else v,
        params,
    )


def _batches(steps, sp, layout, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, BASE["vocab_size"], (N_PEERS, B, T + 1)).astype(np.int32)
        x, y = toks[..., :-1], toks[..., 1:]
        if layout == "zigzag":
            x, y = (np.asarray(ref_zigzag_shard(jnp.asarray(a), sp, axis=2)) for a in (x, y))
        out.append((x, y))
    return out


@pytest.mark.parametrize(
    "variant,sp", [("ring_flash", 4), ("ring_einsum", 2), ("zigzag", 4), ("a2a", 4)]
)
def test_sp_logits_match_flax(variant, sp):
    """The sp model's logits, every strategy and layout, against the Flax
    sp model applied under ``shard_map`` on ``sp`` devices (a2a at sp 4:
    KV 2 % 4, so K/V are expanded before the exchange)."""
    kw = _sp_kw(variant)
    flax_params = jax.tree.map(lambda v: v[0], _stacked_flax_params(1))
    x = _batches(1, sp, kw["sp_layout"], seed=2)[0][0][0]  # [B, T]
    ref_model = ref_llama.Llama(ref_llama.LlamaConfig(**BASE, **kw))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:sp]), ("sp",))
    want = jax.jit(shard_map(
        lambda t: ref_model.apply(flax_params, t), mesh=mesh,
        in_specs=P(None, "sp"), out_specs=P(None, "sp", None),
    ))(jnp.asarray(x))
    model = llama.Llama(llama.LlamaConfig(**BASE, **kw))
    params = {k: torch.from_numpy(v) for k, v in
              convert.flax_llama_to_torch(jax.tree.map(np.asarray, flax_params)).items()}
    with virtual_axis.bind("sp", sp):
        got = llama.apply(model, params, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _sp_steps(variant, sp, overlap, steps=3):
    """Both packages' 2-peer LoRA steps on the sp model: the ring schedule,
    ``lora_optimizer(adam(1e-2))``, a LoRA-only exchange.  Returns the
    initial leaves, the port's and the reference's final leaves (by port
    name) and the per-step (losses, partners) of each."""
    kw = _sp_kw(variant)
    ref_params = _stacked_flax_params(4, STEP_BASE)
    batches = _batches(steps, sp, kw["sp_layout"])
    ref_cfg = ref_config(N_PEERS, schedule="ring", interpolation="loss", factor=0.9)
    mesh = make_sp_mesh(ref_cfg, sp)
    ref_t = IciTransport(ref_cfg, mesh=mesh)
    ref_opt = ref_llama.lora_optimizer(optax.adam(1e-2), jax.tree.map(lambda v: v[0], ref_params))
    ref_model = ref_llama.Llama(ref_llama.LlamaConfig(**STEP_BASE, **kw))

    def ref_loss(params, batch):
        losses = optax.softmax_cross_entropy_with_integer_labels(
            ref_model.apply(params, batch[0]), batch[1]
        )
        return losses.sum(), jnp.float32(losses.size)

    ref_step = ref_make_sp_step(
        ref_loss, ref_opt, ref_t, exchange_filter=ref_llama.lora_filter, overlap=overlap
    )
    ref_state = ref_init_sp_state(ref_params, ref_opt, ref_t)

    model = llama.Llama(llama.LlamaConfig(**STEP_BASE, **kw))
    port_t = stacked.StackedTransport(
        make_local_config(N_PEERS, schedule="ring", interpolation="loss", factor=0.9),
        device="cpu",
    )
    opt = lora_optimizer(adam(1e-2), llama.lora_filter)

    def loss_fn(params, batch):
        losses = softmax_cross_entropy_with_integer_labels(llama.apply(model, params, batch[0]), batch[1])
        return losses.sum(), torch.tensor(float(losses.numel()))

    step = train_sp.make_gossip_sp_train_step(
        loss_fn, opt, port_t, exchange_filter=llama.lora_filter, overlap=overlap, sp=sp
    )
    named = convert.flax_llama_to_torch(jax.tree.map(np.asarray, ref_params))
    state = train_sp.init_gossip_sp_state(
        {k: torch.from_numpy(v) for k, v in named.items()}, opt, port_t
    )
    sh = sp_batch_sharding(mesh)
    record = []
    for x, y in batches:
        ref_state, ref_losses, ref_info = ref_step(
            ref_state, (jax.device_put(x, sh), jax.device_put(y, sh))
        )
        state, losses, info = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        record.append((losses.numpy(), np.asarray(ref_losses),
                       info.partner.numpy(), np.asarray(ref_info.partner)))
    got = {k: v.numpy() for k, v in state.params.views().items()}
    want = convert.flax_llama_to_torch(jax.tree.map(np.asarray, ref_state.params))
    return named, got, want, record


@pytest.mark.parametrize(
    "variant,sp,overlap",
    [("ring_flash", 2, False), ("ring_flash", 4, True), ("zigzag", 2, False),
     ("zigzag", 4, False), ("a2a", 2, False), ("a2a", 4, False)],
)
def test_sp_lora_step_matches_reference(variant, sp, overlap):
    """Three steps of the 2-peer sp LoRA fine-tune against the reference's
    ``make_gossip_sp_train_step``: partners bit-equal, losses and LoRA
    leaves at the reference's tolerances, frozen leaves bit-identical in
    both packages."""
    flash_ring.reset_launch_counts()
    named, got, want, record = _sp_steps(variant, sp, overlap)
    for losses, ref_losses, partners, ref_partners in record:
        np.testing.assert_array_equal(partners, ref_partners)
        np.testing.assert_allclose(losses, ref_losses, rtol=2e-4, atol=2e-5)
    assert list(got) == list(want)
    for name in named:
        if llama.lora_filter(name):
            np.testing.assert_allclose(got[name], want[name], rtol=3e-3, atol=3e-4, err_msg=name)
            assert not np.array_equal(got[name], named[name])
        else:
            np.testing.assert_array_equal(got[name], named[name])
            np.testing.assert_array_equal(want[name], named[name])
    assert flash_ring.ring_hop_fwd.launches == 0  # the plain hops ran on the CPU


def test_sp_config_validation_follows_the_reference():
    for kw in (dict(sp_layout="zigzag"), dict(sp_layout="stripes", sp_axis="sp"),
               dict(sp_strategy="tree", sp_axis="sp"),
               dict(sp_strategy="a2a", sp_layout="zigzag", sp_axis="sp")):
        with pytest.raises(ValueError):
            ref_llama.LlamaConfig(**kw)
        with pytest.raises(ValueError):
            llama.LlamaConfig(**kw)
    model = llama.Llama(llama.LlamaConfig(**BASE, sp_axis="sp"))
    params = llama.init(model, prng.key(0))
    with pytest.raises(NameError, match="unbound axis"):
        llama.apply(model, params, torch.zeros(1, 8, dtype=torch.int64))


def test_sp_model_params_convert_like_the_single_device_model():
    """The sp fields add no parameters: names, shapes and the Flax
    conversion are the single-device model's."""
    single = llama.param_shapes(llama.Llama(llama.LlamaConfig(**BASE)))
    for variant in VARIANTS:
        assert llama.param_shapes(llama.Llama(llama.LlamaConfig(**BASE, **_sp_kw(variant)))) == single
    flax_params = jax.tree.map(lambda v: np.asarray(v[0]), _stacked_flax_params(0))
    named = convert.flax_llama_to_torch(flax_params)
    assert {k: v.shape for k, v in named.items()} == single
    back = convert.torch_llama_to_flax(named)
    jax.tree.map(np.testing.assert_array_equal, back, flax_params)


def test_sp_sequence_checks_and_unported_state():
    assert train_sp.check_sp_sequence(32, 4) == 8
    assert train_sp.check_sp_sequence(32, 4, "zigzag") == 8
    with pytest.raises(ValueError, match="divide by 4"):
        train_sp.check_sp_sequence(30, 4)
    with pytest.raises(ValueError, match="2\\*sp"):
        train_sp.check_sp_sequence(33, 3, "zigzag")
    port_t = stacked.StackedTransport(make_local_config(N_PEERS), device="cpu")
    opt = adam(1e-2)
    step = train_sp.make_gossip_sp_train_step(lambda p, b: (p["w"].sum(), torch.tensor(1.0)),
                                              opt, port_t, sp=4)
    state = train_sp.init_gossip_sp_state({"w": torch.zeros(N_PEERS, 3)}, opt, port_t)
    with pytest.raises(ValueError, match="not divisible by sp"):
        step(state, (torch.zeros(N_PEERS, 1, 6),))
    # The state-carrying step (ported; tests/test_torch_batchnorm.py) wants
    # model state, and each rank's statistics on a leading [sp] axis.
    state_step = train_sp.make_gossip_sp_train_step_with_state(
        lambda p, s, b: ((p["w"].sum(), torch.tensor(1.0)), s), opt, port_t, sp=4)
    with pytest.raises(ValueError, match="model_state"):
        state_step(state, (torch.zeros(N_PEERS, 1, 8),))
    with_ms = train_sp.init_gossip_sp_state(
        {"w": torch.zeros(N_PEERS, 3)}, opt, port_t, {"m": torch.zeros(N_PEERS, 2)})
    with pytest.raises(ValueError, match="sp=4"):
        state_step(with_ms, (torch.zeros(N_PEERS, 1, 8),))


def test_longcontext_example_runs_on_the_cpu():
    """The example's main path at a tiny size (the card's run is
    ``chip_smoke.py``): LoRA with zigzag, the frozen leaves unchanged."""
    from dpwa_tpu_torch.examples import longcontext

    res = longcontext.main(["--device", "cpu", "--peers", "2", "--sp", "2", "--steps", "2",
                            "--seq-len", "32", "--d-model", "32", "--n-layers", "1",
                            "--lora", "4", "--sp-layout", "zigzag", "--log-every", "1"])
    assert res["final_step"] == 2 and res["frozen_unchanged"] is True
    assert all(np.isfinite(res["losses"])) and res["partners"] == [1, 0]
    with pytest.raises(SystemExit):
        longcontext.main(["--device", "cpu", "--sp-layout", "zigzag", "--sp-strategy", "a2a"])
    with pytest.raises(SystemExit):
        longcontext.main(["--device", "cpu", "--sp", "3", "--seq-len", "32"])


FORBIDDEN = ("jax", "flax", "optax", "dpwa_tpu")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_and_chip_smoke_import_no_jax_or_the_reference():
    """No module of the port (``train_sp`` and the new ops among them) and
    nothing in ``chip_smoke.py`` imports JAX, Flax, optax or the reference
    package, at any level of the file."""
    files = sorted((REPO / "dpwa_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = {p.relative_to(REPO).as_posix() for p in files}
    for module in ("train_sp.py", "ops/flash_ring.py", "ops/ring_attention.py",
                   "ops/zigzag_ring.py", "parallel/virtual_axis.py", "examples/longcontext.py"):
        assert f"dpwa_tpu_torch/{module}" in names
    bad = {p.name: sorted(_imported_roots(p) & set(FORBIDDEN)) for p in files}
    assert not any(bad.values()), bad


def test_hop_plans_cover_every_causal_pair_once():
    """Over a ring's hops the plans' panels visit every (query row, key
    row) pair of causal attention exactly once, in both layouts (the
    zigzag's chunks at their global positions)."""
    for layout in ("contiguous", "zigzag"):
        for sp in (1, 2, 4):
            t_local = 8
            stripes, panels = flash_ring.hop_plan(layout, t_local, causal=True)
            pos = (zigzag_positions(sp * t_local, sp).numpy() if layout == "zigzag"
                   else np.arange(sp * t_local))
            seen = np.zeros((sp * t_local, sp * t_local), int)
            for hop in range(sp):
                for stripe, k_off, rule in panels:
                    q_off, rows = stripes[stripe]
                    for me, case in enumerate(flash_ring.hop_cases(sp, hop, rule)):
                        if case == flash_ring.SKIP:
                            continue
                        src = (me - hop) % sp
                        for i in range(rows):
                            for j in range(rows):
                                if case == flash_ring.FULL or j <= i:
                                    seen[pos[me * t_local + q_off + i], pos[src * t_local + k_off + j]] += 1
            np.testing.assert_array_equal(seen, np.tril(np.ones_like(seen)))
