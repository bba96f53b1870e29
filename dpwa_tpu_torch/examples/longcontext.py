#!/usr/bin/env python
"""Long-context gossip training on one card — the port of
``examples/longcontext/main.py``.

    python -m dpwa_tpu_torch.examples.longcontext [--peers N] [--sp S]

Each peer's sequences span a virtual sequence-parallel axis of ``--sp``
ranks: attention is exact ring attention (``--sp-strategy ring``: the hop
kernels B3/B4 on the card, with ``--sp-layout contiguous`` or the balanced
``zigzag``) or Ulysses (``a2a``: B5 per rank), and the peers gossip over
the ring schedule (the exchange kernel B1).  ``--lora RANK`` freezes the
base weights and gossips only the adapters.  Training data is the
reference's synthetic language, batch for batch.  Runs on the CUDA card
unless ``--device cpu`` is given.  :func:`run` takes any model
configuration; ``chip_smoke.py`` passes Llama-3-8B's width through it.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch


def synthetic_batches(n: int, batch_size: int, seq_len: int, sp: int, layout: str, device):
    """The reference example's synthetic language (next token = a fixed
    permutation of the previous, from ``default_rng(0)``): yields
    peer-stacked ``(inputs, targets)`` ``[n, batch, seq_len]`` on
    ``device``, zigzag-sharded for the zigzag layout."""
    from dpwa_tpu_torch.ops.zigzag_ring import zigzag_shard

    rng = np.random.default_rng(0)
    table = rng.permutation(256).astype(np.int32)
    while True:
        starts = rng.integers(1, 256, (n, batch_size, 1)).astype(np.int32)
        toks = [starts]
        for _ in range(seq_len):
            toks.append(table[toks[-1]])
        toks = torch.from_numpy(np.concatenate(toks, axis=-1).astype(np.int64))
        inputs, targets = toks[..., :-1], toks[..., 1:]
        if layout == "zigzag":
            inputs, targets = zigzag_shard(inputs, sp, axis=2), zigzag_shard(targets, sp, axis=2)
        yield inputs.to(device), targets.to(device)


def run(
    model_config,
    *,
    peers: int = 4,
    sp: int = 2,
    steps: int = 60,
    batch_size: int = 2,
    seq_len: int = 256,
    lr: float = 3e-3,
    log_every: int = 20,
    device=None,
    profile: bool = False,
) -> dict:
    """Train ``peers`` replicas of the Llama ``model_config`` (its
    ``sp_axis``, ``sp_layout`` and ``sp_strategy`` set; LoRA when its
    ``lora_rank`` is) for ``steps`` steps, the first one untimed, over a
    virtual axis of ``sp`` ranks.  Prints the rate and returns it with the
    per-step mean losses, the last partners, whether the frozen leaves kept
    every bit, the peak device memory of the steps and, with ``profile``,
    where the timed steps' device time went."""
    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.examples.llama_lora import frozen_checksum
    from dpwa_tpu_torch.models import llama
    from dpwa_tpu_torch.optim import adam, lora_optimizer
    from dpwa_tpu_torch.train import (
        init_params_per_peer,
        softmax_cross_entropy_with_integer_labels,
    )
    from dpwa_tpu_torch.train_sp import (
        check_sp_sequence,
        init_gossip_sp_state,
        make_gossip_sp_train_step,
    )
    from dpwa_tpu_torch.utils import prng, trace
    from dpwa_tpu_torch.utils.launch import build_transport

    if steps < 1:
        raise ValueError("steps must be >= 1")
    if model_config.sp_axis is None:
        raise ValueError("model_config needs sp_axis (the sequence-parallel model)")
    check_sp_sequence(seq_len, sp, model_config.sp_layout)
    bundle = build_transport(make_local_config(peers, schedule="ring"), "stacked", device)
    device = bundle.device
    model = llama.Llama(model_config)
    lora = model_config.lora_rank > 0
    opt = lora_optimizer(adam(lr), llama.lora_filter) if lora else adam(lr)
    exchange_filter = llama.lora_filter if lora else None
    # Every peer from jax.random.key(0), split per peer, as the reference,
    # drawn on the device.
    t_init = time.perf_counter()
    stacked = init_params_per_peer(
        lambda k: llama.init(model, k, device), prng.key(0), peers, device,
        first=opt.trainable,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_seconds = time.perf_counter() - t_init
    state = init_gossip_sp_state(stacked, opt, bundle.transport)

    def sp_loss(params, batch):
        x, y = batch
        losses = softmax_cross_entropy_with_integer_labels(llama.apply(model, params, x), y)
        return losses.sum(), torch.tensor(float(losses.numel()), device=losses.device)

    step_fn = make_gossip_sp_train_step(
        sp_loss, opt, bundle.transport, exchange_filter=exchange_filter, sp=sp
    )
    frozen_before = frozen_checksum(state.params, llama.lora_filter) if lora else None
    batches = synthetic_batches(peers, batch_size, seq_len, sp, model_config.sp_layout, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":  # the steps' peak, not the initialisation's
        torch.cuda.reset_peak_memory_stats(device)
    # The first step (the kernels' build and load, cuBLAS's set-up) runs
    # outside the timed region.
    state, losses, info = step_fn(state, next(batches))
    step_losses = [losses.mean()]
    sync()
    tracer = trace.tracer(device) if profile else contextlib.nullcontext()
    with tracer:
        t0 = time.perf_counter()
        for step in range(1, steps):
            state, losses, info = step_fn(state, next(batches))
            step_losses.append(losses.mean())
            if step % log_every == 0:
                print(
                    f"step {step}: loss/peer {np.round(losses.cpu().numpy(), 3).tolist()} "
                    f"partners {info.partner.cpu().tolist()}"
                )
        sync()
        dt = time.perf_counter() - t0
    steps_per_sec = (steps - 1) / dt if steps > 1 else float("nan")
    mean_losses = torch.stack(step_losses).tolist()
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"peers={peers} x sp={sp} (T={seq_len}): {steps_per_sec:.3f} steps/sec, "
        f"final mean loss {mean_losses[-1]:.4f} (on {where})"
    )
    return {
        "device": where,
        "n_peers": peers,
        "sp": sp,
        "steps": steps,
        "steps_per_sec": steps_per_sec,
        "init_seconds": init_seconds,
        "losses": mean_losses,
        "partners": info.partner.cpu().tolist(),
        "final_step": state.step,
        "lora_column_ranges": len(state.params.column_ranges(exchange_filter)) if lora else None,
        "frozen_unchanged": (
            frozen_checksum(state.params, llama.lora_filter) == frozen_before if lora else None
        ),
        "peak_mem_bytes": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        "profile": trace.breakdown(tracer, dt, steps - 1) if profile else None,
    }


def main(argv=None) -> dict:
    """Parse the reference example's flags (and ``--device``) and :func:`run`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peers", type=int, default=4)
    ap.add_argument("--sp", type=int, default=2)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument(
        "--lora", type=int, default=0, metavar="RANK",
        help="config 5's long-context layout: freeze the base weights, "
        "train rank-RANK LoRA adapters, and gossip ONLY the adapters "
        "over the peers axis (0 = full-weight gossip)",
    )
    ap.add_argument(
        "--sp-layout", choices=("contiguous", "zigzag"), default="contiguous",
        help="zigzag balances causal ring attention work across sp ranks "
        "(ops/zigzag_ring.py); data is zigzag-sharded here, the model "
        "handles rope positions",
    )
    ap.add_argument(
        "--sp-strategy", choices=("ring", "a2a"), default="ring",
        help="'ring': K/V blocks rotate over the sp axis (flash-kernel "
        "hops); 'a2a': Ulysses all-to-all to head-sharded attention over "
        "the full sequence (ops/ulysses.py)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs the kernels' "
        "plain versions on the CPU on purpose)",
    )
    args = ap.parse_args(argv)
    if args.sp_strategy == "a2a" and args.sp_layout == "zigzag":
        raise SystemExit(
            "--sp-layout zigzag balances the causal RING; the a2a strategy "
            "attends over the full sequence and needs the contiguous layout"
        )
    from dpwa_tpu_torch.models import llama
    from dpwa_tpu_torch.train_sp import check_sp_sequence

    try:
        check_sp_sequence(args.seq_len, args.sp, args.sp_layout)
    except ValueError as err:
        raise SystemExit(f"--seq-len: {err}") from None
    mcfg = llama.LlamaConfig(
        vocab_size=256, d_model=args.d_model, n_layers=args.n_layers, n_heads=8,
        n_kv_heads=4, d_ff=args.d_model * 3, max_seq_len=args.seq_len,
        lora_rank=args.lora, sp_axis="sp", sp_layout=args.sp_layout,
        sp_strategy=args.sp_strategy,
    )
    return run(
        mcfg, peers=args.peers, sp=args.sp, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, lr=args.lr, log_every=args.log_every, device=args.device,
    )


if __name__ == "__main__":
    main()
