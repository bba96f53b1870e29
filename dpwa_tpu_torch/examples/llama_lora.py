#!/usr/bin/env python
"""Llama LoRA fine-tune with adapter-only gossip on one card — the port of
``examples/llama_lora/main.py`` with ``--transport stacked``.

    python -m dpwa_tpu_torch.examples.llama_lora [--full-size] [--peers N]

Every peer fine-tunes its own replica of a Llama decoder; the base weights
are hard-frozen (no gradient, no optimizer state, never exchanged) and only
the LoRA adapters gossip, through the pair-merge kernel B1 over their
columns of the flat parameter buffer, under the random schedule (a pool of
16 matchings, one drawn per step).  ``--full-size`` is Llama-3-8B (its
attention runs the flash kernel B5 on the card; at all 32 layers its float32
weights are 32 GB a peer, so ``chip_smoke.py`` calls :func:`run` with the
depth cut to 2); the default is the example's tiny config.  Training data is the reference's synthetic
deterministic language.  Runs on the CUDA card unless ``--device cpu`` is
given.  ``--certify`` and the ``ici`` / ``tcp`` transports are not ported.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch


def frozen_checksum(params, trainable) -> int:
    """The sum of the int32 bit patterns of every frozen parameter: any
    change to any bit of them changes it.  Read in pieces, so it needs
    little memory beside the buffer."""
    total = 0
    for lo, hi in params.column_ranges(lambda name: not trainable(name)):
        for row in params.buffer[:, lo:hi]:
            for start in range(0, hi - lo, 1 << 26):
                piece = row[start : start + (1 << 26)].view(torch.int32)
                total += int(piece.to(torch.int64).sum())
    return total


def synthetic_batches(n: int, batch_size: int, seq_len: int, vocab: int, device):
    """The reference's synthetic language: each sequence starts at a random
    token and continues ``t ← (3·t + 1) mod V``; yields peer-stacked
    ``(tokens, targets)`` ``[n, batch, seq_len]`` on ``device``, from the
    reference's seed 0."""
    rng = np.random.default_rng(0)
    while True:
        seq = [rng.integers(1, vocab, (n, batch_size, 1))]
        for _ in range(seq_len):
            seq.append((3 * seq[-1] + 1) % vocab)
        toks = np.concatenate(seq, axis=-1)
        yield (
            torch.from_numpy(toks[..., :-1].astype(np.int64)).to(device),
            torch.from_numpy(toks[..., 1:].astype(np.int64)).to(device),
        )


def run(
    model_config,
    *,
    peers: int = 8,
    steps: int = 100,
    batch_size: int = 4,
    seq_len: int = 64,
    lr: float = 1e-3,
    device=None,
    wire_dtype: str | None = None,
    mode: str | None = None,
    transport: str = "stacked",
    log_every: int = 20,
    profile: bool = False,
) -> dict:
    """Fine-tune ``peers`` replicas of the Llama ``model_config`` for
    ``steps`` steps (the first one untimed), print the rate, and return
    it with the per-step mean losses and what the run went through: the
    exchanged payload, the LoRA column ranges (B1 launches per step),
    whether the frozen leaves kept every bit, the peak device memory of the
    initialisation and of the steps, and with ``profile`` where the timed
    steps' device time went."""
    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.models import llama
    from dpwa_tpu_torch.optim import adam, lora_optimizer
    from dpwa_tpu_torch.train import (
        init_params_per_peer,
        softmax_cross_entropy_with_integer_labels,
    )
    from dpwa_tpu_torch.utils import prng, trace
    from dpwa_tpu_torch.utils.launch import build_transport
    from dpwa_tpu_torch.utils.pytree import tree_wire_bytes

    if steps < 1:
        raise ValueError("steps must be >= 1")
    cfg = make_local_config(peers, schedule="random", pool_size=16)
    bundle = build_transport(cfg, transport, device, wire_dtype=wire_dtype, mode=mode)
    cfg, device = bundle.config, bundle.device
    if device.type == "cuda":  # the initialisation's peak, read below
        torch.cuda.reset_peak_memory_stats(device)
    model = llama.Llama(model_config)
    opt = lora_optimizer(adam(lr), llama.lora_filter)
    # Every peer from jax.random.key(0), split per peer, as the reference,
    # drawn on the device; built in the layout the optimizer needs (the
    # LoRA leaves first), so the state takes the buffer over as it is.
    t_init = time.perf_counter()
    stacked = init_params_per_peer(
        lambda k: llama.init(model, k, device), prng.key(0), peers, device,
        first=opt.trainable,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_seconds = time.perf_counter() - t_init
    state = bundle.init_state(stacked, opt, bundle.transport)

    def loss_fn(params, batch):
        tokens, targets = batch
        logits = llama.apply(model, params, tokens)
        return softmax_cross_entropy_with_integer_labels(logits, targets).mean()

    step_fn = bundle.make_step(
        loss_fn, opt, bundle.transport, exchange_filter=llama.lora_filter
    )
    views = state.params.views()
    total_bytes = sum(v[0].numel() * v.element_size() for v in views.values())
    payload = tree_wire_bytes(
        {k: v[0] for k, v in views.items() if llama.lora_filter(k)},
        cfg.protocol.wire_dtype,
    )
    del views
    lora_ranges = len(state.params.column_ranges(llama.lora_filter))
    frozen_before = frozen_checksum(state.params, llama.lora_filter)
    batches = synthetic_batches(peers, batch_size, seq_len, model_config.vocab_size, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    init_peak = None
    if device.type == "cuda":  # the steps' peak, not the initialisation's
        init_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    # The first step (the kernels' build and load, cuBLAS's set-up) runs
    # outside the timed region.
    state, losses, _ = step_fn(state, next(batches))
    step_losses = [losses.mean()]
    sync()
    tracer = trace.tracer(device) if profile else contextlib.nullcontext()
    with tracer:
        t0 = time.perf_counter()
        for _ in range(1, steps):
            state, losses, _ = step_fn(state, next(batches))
            step_losses.append(losses.mean())
        sync()
        dt = time.perf_counter() - t0
    steps_per_sec = (steps - 1) / dt if steps > 1 else float("nan")
    mean_losses = torch.stack(step_losses).tolist()
    for step in range(0, steps, log_every):
        print(f"step {step}: mean loss {mean_losses[step]:.4f}")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"Llama x{peers} peers; model {total_bytes / 1e6:.1f} MB per peer, "
        f"gossiped LoRA payload {payload / 1e6:.3f} MB/exchange in "
        f"{lora_ranges} column range(s)"
    )
    print(
        f"steps/sec (all {peers} peers, incl. exchange, on {where} x1): "
        f"{steps_per_sec:.3f}"
    )
    return {
        "device": where,
        "n_peers": peers,
        "steps": steps,
        "steps_per_sec": steps_per_sec,
        "init_seconds": init_seconds,
        "losses": mean_losses,
        "final_step": state.step,
        "payload_bytes": payload,
        "model_bytes_per_peer": total_bytes,
        "lora_column_ranges": lora_ranges,
        "frozen_unchanged": frozen_checksum(state.params, llama.lora_filter) == frozen_before,
        "peak_mem_bytes": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        "init_peak_mem_bytes": init_peak,
        "profile": trace.breakdown(tracer, dt, steps - 1) if profile else None,
    }


def main(argv=None) -> dict:
    """Parse the reference example's flags and :func:`run`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peers", type=int, default=8)
    ap.add_argument("--lora-rank", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-size", action="store_true",
                    help="real Llama-3-8B dims (5.95 GB of float32 weights per peer)")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--certify", action="store_true",
                    help="the chaos-certification leg (not ported)")
    ap.add_argument("--certify-peers", type=int, default=4)
    ap.add_argument("--certify-port", type=int, default=47300)
    ap.add_argument(
        "--profile", action="store_true",
        help="trace the timed steps with torch.profiler and report where the "
        "device time goes (the rate then includes the profiler's cost)",
    )
    from dpwa_tpu_torch.models import llama
    from dpwa_tpu_torch.utils.launch import add_transport_args

    add_transport_args(ap)
    args = ap.parse_args(argv)
    if args.certify:
        raise NotImplementedError(
            "--certify runs the multi-process TCP stack, which is not ported yet"
        )
    if args.full_size:
        mcfg = llama.llama3_8b_config(lora_rank=args.lora_rank)
    else:
        mcfg = llama.LlamaConfig(
            vocab_size=256, d_model=64, n_layers=4, n_heads=8, n_kv_heads=4,
            d_ff=128, max_seq_len=args.seq_len, lora_rank=args.lora_rank,
        )
    return run(
        mcfg, peers=args.peers, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, lr=args.lr, device=args.device,
        wire_dtype=args.wire_dtype, mode=args.mode, transport=args.transport,
        log_every=args.log_every, profile=args.profile,
    )


if __name__ == "__main__":
    main()
