#!/usr/bin/env python
"""BERT MLM with hierarchical intra/inter-group gossip on one card — the
port of ``examples/bert/main.py`` with ``--transport stacked`` (BASELINE
config 4: "BERT-base MLM, 64-peer gossip, hierarchical intra/inter-host
averaging").

    python -m dpwa_tpu_torch.examples.bert --peers 16 --steps 6
    python -m dpwa_tpu_torch.examples.bert --tiny --device cpu --peers 8 --group-size 4

Peers form groups of ``--group-size`` (chips per host in the reference);
most steps pair peers inside their group, every ``--inter-period``-th step
pairs them across groups, and the pair-merge kernel B1 merges each pair's
whole model in place.  Every peer starts from the same weights, the
reference's ``model.init(jax.random.key(0), …)``, and trains with AdamW.
With no corpus on disk it trains on the reference's synthetic language
(next token ``(2·t + 1) mod V``), drawn afresh every step from
``numpy.random.default_rng(0)`` and masked by ``mlm_mask_batch``, so the
loss is learnable.  Runs on the CUDA card unless ``--device cpu`` is given.
``--certify`` and the ``ici`` / ``tcp`` transports are not ported.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch


def synthetic_batches(n: int, batch_size: int, seq_len: int, vocab: int, device):
    """The reference's batches, one a step from ``default_rng(0)``: each
    sequence starts at a random token and continues ``t ← (2·t + 1) mod V``,
    then :func:`~dpwa_tpu_torch.models.bert.mlm_mask_batch` masks it with
    the same generator.  Yields peer-stacked ``(inputs, targets, weights)``
    ``[n, batch, seq_len]`` on ``device``, copied from pinned memory without
    waiting on a card."""
    from dpwa_tpu_torch.models.bert import mlm_mask_batch

    rng = np.random.default_rng(0)
    while True:
        seq = [rng.integers(1, vocab, (n, batch_size, 1))]
        for _ in range(seq_len - 1):
            seq.append((2 * seq[-1] + 1) % vocab)
        batch = mlm_mask_batch(np.concatenate(seq, axis=-1), rng)
        if device.type == "cuda":
            yield tuple(
                torch.from_numpy(a).pin_memory().to(device, non_blocking=True) for a in batch
            )
        else:
            yield tuple(torch.from_numpy(a) for a in batch)


def main(argv=None) -> dict:
    """Train, print the payload and the rate, and return them with the
    per-step mean losses and partners, the peak memory and, with
    ``--profile``, where the timed steps' device time went."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peers", type=int, default=64)
    ap.add_argument("--group-size", type=int, default=8)
    ap.add_argument("--inter-period", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--tiny", action="store_true", help="tiny BERT (tests)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute in the attention and Dense layers")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--certify", action="store_true",
                    help="the chaos-certification leg (not ported)")
    ap.add_argument(
        "--profile", action="store_true",
        help="trace the timed steps with torch.profiler and report where the "
        "device time goes (the rate then includes the profiler's cost)",
    )
    from dpwa_tpu_torch.utils.launch import add_transport_args, build_transport

    add_transport_args(ap)
    args = ap.parse_args(argv)
    if args.certify:
        raise NotImplementedError(
            "--certify runs the multi-process TCP stack, which is not ported yet"
        )
    if args.steps < 1:
        ap.error("--steps must be >= 1")

    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.models import bert
    from dpwa_tpu_torch.optim import adamw
    from dpwa_tpu_torch.train import stack_params
    from dpwa_tpu_torch.utils import prng, trace
    from dpwa_tpu_torch.utils.pytree import tree_wire_bytes

    dtype = torch.bfloat16 if args.bf16 else None
    mcfg = bert.bert_tiny_config(dtype) if args.tiny else bert.bert_base_config(dtype)
    if args.seq_len > mcfg.max_seq_len:
        hint = " (tiny BERT is 64)" if args.tiny else ""
        ap.error(
            f"--seq-len {args.seq_len} exceeds the model's max_seq_len "
            f"{mcfg.max_seq_len}{hint}; pass --seq-len "
            f"{mcfg.max_seq_len} or less"
        )
    cfg = make_local_config(
        args.peers, schedule="hierarchical", group_size=args.group_size,
        inter_period=args.inter_period,
    )
    bundle = build_transport(
        cfg, args.transport, args.device, wire_dtype=args.wire_dtype, mode=args.mode,
        fetch_probability=args.fetch_probability, drop_probability=args.drop_probability,
    )
    cfg, transport, device = bundle.config, bundle.transport, bundle.device
    n = cfg.n_peers

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    model = bert.BertMLM(mcfg)
    # One draw from jax.random.key(0), the same on every peer, as the
    # reference's stack_params(model.init(key(0), …), n).
    t_init = time.perf_counter()
    stacked = stack_params(bert.init(model, prng.key(0), device), n, device)
    sync()
    init_seconds = time.perf_counter() - t_init
    opt = adamw(args.lr)
    state = bundle.init_state(stacked, opt, transport)
    step_fn = bundle.make_step(bert.mlm_loss_fn(model), opt, transport)
    payload = tree_wire_bytes(
        {k: v[0] for k, v in state.params.views().items()}, cfg.protocol.wire_dtype
    )
    print(
        f"BERT {'tiny' if args.tiny else 'base'} x{n} peers "
        f"({n // args.group_size} groups), payload {payload / 1e6:.1f} MB",
        file=sys.stderr,
    )
    batches = synthetic_batches(n, args.batch_size, args.seq_len, mcfg.vocab_size, device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # The first step (the kernels' build and load, cuBLAS's set-up) runs
    # outside the timed region.
    state, losses, info = step_fn(state, next(batches))
    step_losses, partners = [losses.mean()], [info.partner]
    sync()
    tracer = trace.tracer(device) if args.profile else contextlib.nullcontext()
    with tracer:
        t0 = time.perf_counter()
        for _ in range(1, args.steps):
            state, losses, info = step_fn(state, next(batches))
            step_losses.append(losses.mean())
            partners.append(info.partner)
        sync()
        dt = time.perf_counter() - t0
    timed = args.steps - 1
    steps_per_sec = timed / dt if timed else float("nan")
    mean_losses = torch.stack(step_losses).tolist()
    for step in range(0, args.steps, args.log_every):
        print(f"step {step}: mean loss {mean_losses[step]:.4f}")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"steps/sec (all {n} peers, incl. exchange, on {where} x1): "
        f"{steps_per_sec:.3f}"
    )
    tokens = n * args.batch_size * args.seq_len
    return {
        "device": where,
        "n_peers": n,
        "steps": args.steps,
        "batch_size": args.batch_size,
        "seq_len": args.seq_len,
        "steps_per_sec": steps_per_sec,
        "tokens_per_sec": steps_per_sec * tokens,
        "init_seconds": init_seconds,
        "losses": mean_losses,
        "partners": torch.stack(partners).tolist(),
        "payload_bytes": payload,
        "params_per_peer": state.params.size,
        "peak_mem_bytes": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        "final_step": state.step,
        "profile": trace.breakdown(tracer, dt, timed) if args.profile else None,
    }


if __name__ == "__main__":
    main()
