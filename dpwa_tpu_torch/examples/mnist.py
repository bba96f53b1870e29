#!/usr/bin/env python
"""MNIST gossip training on one card — the port of
``examples/mnist/main.py`` with ``--transport stacked``.

    python -m dpwa_tpu_torch.examples.mnist --config examples/mnist/nodes.yaml

Every peer of the YAML config (2 in ``examples/mnist/nodes.yaml``, ring, α
0.5) trains its own replica on its own shard with Adam; all peers live on
one device as a stacked axis and gossip their parameters every step
through the pair-merge kernel.  The data are full MNIST (``ConvNet``) when
an ``mnist.npz`` lies under ``data/mnist``, else the 8×8 digits committed
in ``data/digits_fixture`` (``SmallNet``).

``--checkpoint DIR`` saves the whole state and the data stream's position
every ``--save-every`` steps; ``--resume`` continues from DIR the exact run
(the same batches and the same exchanges).  Runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]


def main(argv=None) -> dict:
    """Train, print each peer's test accuracy and their mean, and return
    what ``examples.cifar10.main`` returns (the rate, the per-step mean
    losses and participation, the accuracies, …) plus the seconds spent
    saving and restoring, the final state and the data stream."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=str(REPO / "examples/mnist/nodes.yaml"))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument(
        "--checkpoint", metavar="DIR",
        help="save the full state and the data stream's position here every "
        "--save-every steps; with --resume, continue the exact run (same "
        "batches, same exchange sequence)",
    )
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument(
        "--profile", action="store_true",
        help="trace the timed steps with torch.profiler and report where the "
        "device time goes (the rate then includes the profiler's cost)",
    )
    from dpwa_tpu_torch.utils.launch import add_transport_args, build_transport

    add_transport_args(ap)
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint:
        ap.error("--resume requires --checkpoint DIR")
    if args.steps < 1 or args.save_every < 1:
        ap.error("--steps and --save-every must be >= 1")

    from dpwa_tpu_torch import checkpoint
    from dpwa_tpu_torch.config import load_config
    from dpwa_tpu_torch.data import device_batches, load_mnist_or_digits, peer_batches
    from dpwa_tpu_torch.models import mnist
    from dpwa_tpu_torch.optim import adam
    from dpwa_tpu_torch.train import (
        init_params_per_peer,
        make_gossip_eval_fn,
        softmax_cross_entropy_with_integer_labels,
    )
    from dpwa_tpu_torch.utils import prng, trace
    from dpwa_tpu_torch.utils.pytree import tree_wire_bytes

    bundle = build_transport(
        load_config(args.config), args.transport, args.device,
        wire_dtype=args.wire_dtype, mode=args.mode,
        fetch_probability=args.fetch_probability, drop_probability=args.drop_probability,
    )
    cfg, transport, device = bundle.config, bundle.transport, bundle.device
    x_tr, y_tr, x_te, y_te, dataset = load_mnist_or_digits()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n = cfg.n_peers
    model = mnist.build_model(x_tr.shape[1:]).to(device)
    # Every peer from jax.random.key(0), split per peer, as the reference.
    t_init = time.perf_counter()
    stacked = init_params_per_peer(lambda k: mnist.init(model, k, device), prng.key(0), n, device)
    sync()
    init_seconds = time.perf_counter() - t_init
    opt = adam(args.lr)
    state = bundle.init_state(stacked, opt, transport)

    def apply(params, x):
        return torch.func.functional_call(model, params, (x,))

    def loss_fn(params, batch):
        x, y = batch
        return softmax_cross_entropy_with_integer_labels(apply(params, x), y).mean()

    step_fn = bundle.make_step(loss_fn, opt, transport)
    payload = tree_wire_bytes(
        {k: v[0] for k, v in state.params.views().items()}, cfg.protocol.wire_dtype
    )
    stream = peer_batches(x_tr, y_tr, n, args.batch_size, seed=cfg.protocol.seed)
    start, restore_seconds, save_seconds = 0, 0.0, 0.0
    if args.checkpoint:
        # The stream is read directly, one batch a step: a lookahead would
        # save a cursor ahead of what training consumed, and a resume would
        # skip those batches.
        batches = (tuple(torch.from_numpy(a).to(device) for a in b) for b in stream)
        if args.resume:
            t0 = time.perf_counter()
            state = checkpoint.restore_checkpoint(args.checkpoint, like=state, data_stream=stream)
            sync()
            restore_seconds = time.perf_counter() - t0
            start = state.step
            print(f"resumed at step {start} (batch {stream.batch_count})")
    else:
        batches = device_batches(stream, device)

    participated = []

    def run_step(step: int):
        nonlocal state, save_seconds
        state, losses, info = step_fn(state, next(batches))
        participated.append(info.participated)
        if args.checkpoint and (step + 1) % args.save_every == 0:
            sync()  # the step done: the save's time is its own
            t0 = time.perf_counter()
            checkpoint.save_checkpoint(args.checkpoint, state, data_stream=stream)
            save_seconds += time.perf_counter() - t0
        return losses.mean()

    # The first step (cuDNN's algorithm choice, the kernels' build and
    # load) runs outside the timed region.
    step_losses = [run_step(start)] if start < args.steps else []
    sync()
    tracer = trace.tracer(device) if args.profile else contextlib.nullcontext()
    with tracer:
        t0 = time.perf_counter()
        for step in range(start + 1, args.steps):
            step_losses.append(run_step(step))
        sync()
        dt = time.perf_counter() - t0
    timed = args.steps - start - 1
    steps_per_sec = timed / dt if timed > 0 else float("nan")
    mean_losses = torch.stack(step_losses).tolist() if step_losses else []
    for i in range(0, len(mean_losses), args.log_every):
        print(f"step {start + i}: mean loss {mean_losses[i]:.4f}")

    eval_fn = make_gossip_eval_fn(apply)
    accs = eval_fn(
        state.params, torch.from_numpy(x_te).to(device), torch.from_numpy(y_te).to(device)
    ).tolist()
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{dataset} per-peer test accuracy: {[round(a, 4) for a in accs]}")
    print(f"steps/sec (all {n} peers, incl. exchange, on {where} x1): {steps_per_sec:.3f}")
    print(f"mean test accuracy: {float(np.mean(accs)):.4f}")
    return {
        "dataset": dataset,
        "device": where,
        "n_peers": n,
        "steps": args.steps,
        "start_step": start,
        "steps_per_sec": steps_per_sec,
        "init_seconds": init_seconds,
        "losses": mean_losses,
        "participated": torch.stack(participated).tolist() if participated else [],
        "accuracy": accs,
        "payload_bytes": payload,
        "final_step": state.step,
        "save_seconds": save_seconds,
        "restore_seconds": restore_seconds,
        "state": state,
        "stream": stream,
        "profile": trace.breakdown(tracer, dt, timed) if args.profile and timed > 0 else None,
    }


if __name__ == "__main__":
    main()
