#!/usr/bin/env python
"""MNIST gossip training on the card — the port of ``examples/mnist/main.py``
with ``--transport stacked`` and ``--transport tcp``.

Stacked (one process, every peer on one device)::

    python -m dpwa_tpu_torch.examples.mnist --config examples/mnist/nodes.yaml

TCP (the reference's deployment: one process per YAML node, here all on
one card)::

    python -m dpwa_tpu_torch.examples.mnist --transport tcp --name node0 &
    python -m dpwa_tpu_torch.examples.mnist --transport tcp --name node1 &

Every peer of the YAML config (2 in ``examples/mnist/nodes.yaml``, ring, α
0.5) trains its own replica on its own shard with Adam.  Stacked, all
peers live on one device as a stacked axis and gossip their parameters
every step through the pair-merge kernel.  Over TCP each process inits its
replica from ``jax.random.key(me)``'s draws, draws its batches from
``default_rng(1000 + me)``, and gossips through
:class:`~dpwa_tpu_torch.adapters.tcp_adapter.DpwaTcpAdapter` (B2 merges
each fetched frame on the card), as the reference's ``run_tcp``; at the
end it prints its test accuracy and one JSON line of its counts.  The
data are full MNIST (``ConvNet``) when an ``mnist.npz`` lies under
``data/mnist``, else the 8×8 digits committed in ``data/digits_fixture``
(``SmallNet``).

``--checkpoint DIR`` saves the whole state and the data stream's position
every ``--save-every`` steps; ``--resume`` continues from DIR the exact run
(the same batches and the same exchanges).  Runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
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
    if args.transport == "tcp":
        if not args.name:
            ap.error("--transport tcp requires --name (this node's identity)")
        if args.checkpoint or args.profile:
            ap.error("--checkpoint and --profile are not wired into the per-process tcp loop")
        return run_tcp(args)

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


def run_tcp(args) -> dict:
    """One node of the TCP deployment (the reference's ``run_tcp``):
    train this node's replica and gossip it every step; returns the
    node's losses, test accuracy, rate, merged rounds, fetch outcomes, wire
    bytes, host copies per received frame, B2 launches and peak device
    memory."""
    from dpwa_tpu_torch.adapters.tcp_adapter import DpwaTcpAdapter
    from dpwa_tpu_torch.config import load_config
    from dpwa_tpu_torch.data import load_mnist_or_digits, peer_split
    from dpwa_tpu_torch.models import mnist
    from dpwa_tpu_torch.ops import merge
    from dpwa_tpu_torch.optim import adam
    from dpwa_tpu_torch.parallel import ingest
    from dpwa_tpu_torch.train import softmax_cross_entropy_with_integer_labels
    from dpwa_tpu_torch.utils import prng
    from dpwa_tpu_torch.utils.launch import build_transport

    bundle = build_transport(
        load_config(args.config), "tcp", args.device, wire_dtype=args.wire_dtype,
        mode=args.mode, fetch_probability=args.fetch_probability,
        drop_probability=args.drop_probability, name=args.name,
    )
    cfg, device = bundle.config, bundle.device
    me = cfg.node_index(args.name)
    x_tr, y_tr, x_te, y_te, dataset = load_mnist_or_digits()
    xs, ys = peer_split(x_tr, y_tr, cfg.n_peers, seed=cfg.protocol.seed)
    x_my = torch.from_numpy(xs[me]).to(device)
    y_my = torch.from_numpy(ys[me]).to(device)
    model = mnist.build_model(x_tr.shape[1:]).to(device)
    params = mnist.init(model, prng.key(me), device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    adapter = DpwaTcpAdapter(params, args.name, cfg, transport=bundle.transport)
    params = adapter.params
    flat = adapter.flat
    opt = adam(args.lr)
    opt_state = opt.init(flat.flat)

    def loss_fn(p, xb, yb):
        logits = torch.func.functional_call(model, p, (xb,))
        return softmax_cross_entropy_with_integer_labels(logits, yb).mean()

    grad_fn = torch.func.grad_and_value(loss_fn)
    rng = np.random.default_rng(1000 + me)
    launches0 = merge.gather_merge.launches
    losses = []
    t0 = None
    try:
        for step in range(args.steps):
            if step == 1:  # the first step (the kernels' build and load) untimed
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
            idx = torch.from_numpy(rng.integers(0, len(xs[me]), size=args.batch_size)).to(device)
            grads, loss = grad_fn(params, x_my[idx], y_my[idx])
            updates = opt.update_(flat.pack({k: g[None] for k, g in grads.items()}), opt_state)
            flat.add_(updates)
            loss = float(loss)
            params = adapter.update(loss)
            losses.append(loss)
            if step % args.log_every == 0:
                print(json.dumps({"step": step, "node": args.name, "loss": loss,
                                  "alpha": adapter.last_alpha, "partner": adapter.last_partner}),
                      flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0 if t0 is not None else float("nan")
        with torch.no_grad():
            logits = torch.func.functional_call(model, params, (torch.from_numpy(x_te).to(device),))
        acc = float((logits.argmax(-1).cpu().numpy() == y_te).mean())
        print(f"[{args.name}] {dataset} test accuracy: {acc:.4f}", flush=True)
        stats = adapter.transport.stats
        result = {
            "node": args.name,
            "dataset": dataset,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "steps": args.steps,
            "steps_per_sec": (args.steps - 1) / dt if args.steps > 1 else float("nan"),
            "losses": losses,
            "accuracy": acc,
            "rounds": stats["rounds"],
            "merged_rounds": stats["merged"],
            "outcomes": dict(stats["outcomes"]),
            "wire_bytes_published": stats["wire_bytes_published"],
            "wire_bytes_fetched": stats["wire_bytes_fetched"],
            # host copies of a landed payload before its copy to the device
            # (0: the frame crossed from the receive buffer it landed in)
            "rx_copies_per_frame": ingest.rx_stats()["copies_per_frame"],
            "b2_launches": merge.gather_merge.launches - launches0,
            "peak_memory_bytes": (
                torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
            ),
        }
    finally:
        adapter.close()
    return result


if __name__ == "__main__":
    out = main()
    if out.get("node") is not None:  # a tcp node: its counts, one JSON line
        print(json.dumps({k: v for k, v in out.items() if k != "losses"}))
