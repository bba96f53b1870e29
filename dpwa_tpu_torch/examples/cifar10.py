#!/usr/bin/env python
"""CIFAR-10 ResNet-20, 8-peer ring gossip on one card — the port of
``examples/cifar10/main.py`` with ``--transport stacked``.

    python -m dpwa_tpu_torch.examples.cifar10 \\
        --config examples/cifar10/nodes.yaml --data-dir data/cifar10_fixture

Every peer trains ResNet-20 on its own shard; all peers live on one device
as a stacked axis and ring-gossip their parameters every step through the
pair-merge kernel.  CIFAR-10 is read from ``--data-dir`` (an npz or the
python pickle batches); ``--synthetic`` trains on generated 32×32 data, the
real model, schedule and exchange, so the rate is valid but the accuracy is
chance.  Runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]


def load_cifar10(data_dir: str):
    """CIFAR-10 from the canonical python pickle batches or an npz."""
    npz = os.path.join(data_dir, "cifar10.npz")
    if os.path.exists(npz):
        with np.load(npz) as d:
            return (
                d["x_train"].astype(np.float32) / 255.0,
                d["y_train"].astype(np.int32),
                d["x_test"].astype(np.float32) / 255.0,
                d["y_test"].astype(np.int32),
            )
    batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
    if os.path.isdir(batch_dir):
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(batch_dir, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(d[b"labels"])
        x_tr = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y_tr = np.concatenate(ys)
        with open(os.path.join(batch_dir, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x_te = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y_te = np.asarray(d[b"labels"])
        return (
            x_tr.astype(np.float32) / 255.0,
            y_tr.astype(np.int32),
            x_te.astype(np.float32) / 255.0,
            y_te.astype(np.int32),
        )
    raise FileNotFoundError(f"no CIFAR-10 under {data_dir}")


def synthetic_cifar(n_train=4096, n_test=512, seed=0):
    rng = np.random.default_rng(seed)
    x_tr = rng.random((n_train, 32, 32, 3), np.float32)
    y_tr = rng.integers(0, 10, n_train).astype(np.int32)
    x_te = rng.random((n_test, 32, 32, 3), np.float32)
    y_te = rng.integers(0, 10, n_test).astype(np.int32)
    return x_tr, y_tr, x_te, y_te


def main(argv=None) -> dict:
    """Train, print the rate and accuracy, and return them with the
    per-step mean losses."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=str(REPO / "examples/cifar10/nodes.yaml"))
    ap.add_argument("--data-dir", default=str(REPO / "data/cifar10_fixture"))
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    ap.add_argument(
        "--profile", action="store_true",
        help="trace the timed steps with torch.profiler and report where the "
        "device time goes (the rate then includes the profiler's cost)",
    )
    from dpwa_tpu_torch.utils.launch import add_transport_args, build_transport

    add_transport_args(ap)
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")

    from dpwa_tpu_torch.config import load_config
    from dpwa_tpu_torch.data import device_batches, peer_batches
    from dpwa_tpu_torch.models import resnet
    from dpwa_tpu_torch.optim import sgd
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
    if args.synthetic:
        x_tr, y_tr, x_te, y_te = synthetic_cifar()
        dataset = "synthetic-cifar-shaped"
    else:
        x_tr, y_tr, x_te, y_te = load_cifar10(args.data_dir)
        dataset = "cifar10"

    n = cfg.n_peers
    model = resnet.ResNet20(
        dtype=torch.bfloat16 if args.bf16 else torch.float32
    ).to(device)
    # Every peer from jax.random.key(0), split per peer, as the reference.
    t_init = time.perf_counter()
    stacked = init_params_per_peer(
        lambda k: resnet.init(model, k, device), prng.key(0), n, device
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_seconds = time.perf_counter() - t_init
    opt = sgd(args.lr, momentum=0.9)
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
    if args.synthetic:
        # Cycle a few staged batches: regenerating host batches every step
        # would time numpy and the host link, not the training system.
        import itertools

        batches = itertools.cycle(list(device_batches(
            (next(stream) for _ in range(4)), device
        )))
    else:
        batches = device_batches(stream, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # The first step (cuDNN's algorithm choice, the kernels' build and
    # load) runs outside the timed region.
    state, losses, info = step_fn(state, next(batches))
    step_losses, participated = [losses.mean()], [info.participated]
    sync()
    tracer = trace.tracer(device) if args.profile else contextlib.nullcontext()
    with tracer:
        t0 = time.perf_counter()
        for _ in range(1, args.steps):
            state, losses, info = step_fn(state, next(batches))
            step_losses.append(losses.mean())
            participated.append(info.participated)
        sync()
        dt = time.perf_counter() - t0
    steps_per_sec = (args.steps - 1) / dt if args.steps > 1 else float("nan")
    mean_losses = torch.stack(step_losses).tolist()
    for step in range(0, args.steps, args.log_every):
        print(f"step {step}: mean loss {mean_losses[step]:.4f}")

    eval_fn = make_gossip_eval_fn(apply)
    accs = eval_fn(
        state.params,
        torch.from_numpy(x_te).to(device),
        torch.from_numpy(y_te).to(device),
    ).tolist()
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    acc_note = "" if dataset == "cifar10" else " (synthetic labels: chance-level)"
    print(f"dataset: {dataset}")
    print(
        f"steps/sec (all {n} peers, incl. exchange, on {where} x1): "
        f"{steps_per_sec:.3f}"
    )
    print(f"mean test accuracy: {float(np.mean(accs)):.4f}{acc_note}")
    return {
        "dataset": dataset,
        "device": where,
        "n_peers": n,
        "steps": args.steps,
        "steps_per_sec": steps_per_sec,
        "init_seconds": init_seconds,
        "losses": mean_losses,
        "participated": torch.stack(participated).tolist(),
        "accuracy": accs,
        "payload_bytes": payload,
        "final_step": state.step,
        "profile": trace.breakdown(tracer, dt, args.steps - 1) if args.profile else None,
    }


if __name__ == "__main__":
    main()
