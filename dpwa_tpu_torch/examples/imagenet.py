#!/usr/bin/env python
"""ImageNet ResNet-50, 32-peer random-pair gossip on one card — the port of
``examples/imagenet/main.py`` with ``--transport stacked`` (BASELINE config
3: "ImageNet ResNet-50, 32-peer random-pair schedule").

    python -m dpwa_tpu_torch.examples.imagenet --steps 6 --batch-size 4

Every peer trains ResNet-50 (GroupNorm) on its own shard; every step a
random perfect matching from the schedule's pool of 32 pairs the peers, and
the pair-merge kernel merges each pair's parameters in place.  As in the
reference there is no ImageNet loader: two ImageNet-shaped synthetic batches
from ``numpy.random.default_rng(0)`` are staged on the device and cycled,
so the rate is the training system's (model, schedule and exchange) and the
loss is chance.  Every peer starts from the reference's weights for
``jax.random.key(0)``, split per peer.  Runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    """Train, print the rate, and return it with the per-step mean losses."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peers", type=int, default=32)
    ap.add_argument("--config", help="optional YAML (overrides --peers)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    ap.add_argument("--log-every", type=int, default=20)
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

    from dpwa_tpu_torch.config import load_config, make_local_config
    from dpwa_tpu_torch.models import resnet
    from dpwa_tpu_torch.optim import sgd
    from dpwa_tpu_torch.train import (
        init_params_per_peer,
        softmax_cross_entropy_with_integer_labels,
    )
    from dpwa_tpu_torch.utils import prng, trace
    from dpwa_tpu_torch.utils.pytree import tree_wire_bytes

    if args.config:
        cfg = load_config(args.config)
    else:
        cfg = make_local_config(args.peers, schedule="random", pool_size=32)
    bundle = build_transport(
        cfg, args.transport, args.device, wire_dtype=args.wire_dtype, mode=args.mode,
        fetch_probability=args.fetch_probability, drop_probability=args.drop_probability,
    )
    cfg, transport, device = bundle.config, bundle.transport, bundle.device
    n, s = cfg.n_peers, args.image_size

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    t_init = time.perf_counter()
    model = resnet.ResNet50(dtype=dtype, device=device)
    # Every peer from jax.random.key(0), split per peer, as the reference.
    stacked = init_params_per_peer(
        lambda k: resnet.init(model, k, device), prng.key(0), n, device
    )
    sync()
    init_seconds = time.perf_counter() - t_init
    opt = sgd(args.lr, momentum=0.9)
    state = bundle.init_state(stacked, opt, transport)

    def loss_fn(params, batch):
        x, y = batch
        logits = torch.func.functional_call(model, params, (x,))
        return softmax_cross_entropy_with_integer_labels(logits, y).mean()

    step_fn = bundle.make_step(loss_fn, opt, transport)
    payload = tree_wire_bytes(
        {k: v[0] for k, v in state.params.views().items()}, cfg.protocol.wire_dtype
    )

    # Two synthetic batches staged on the device and cycled, as the
    # reference does: regenerating them every step would time numpy and the
    # host link, not the training system.
    rng = np.random.default_rng(0)
    pool = []
    for _ in range(2):
        x = rng.random((n, args.batch_size, s, s, 3), np.float32)
        y = rng.integers(0, 1000, (n, args.batch_size)).astype(np.int32)
        pool.append((torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # The first step (cuDNN's algorithm choice, the kernels' build and
    # load) runs outside the timed region.
    state, losses, _ = step_fn(state, pool[0])
    step_losses = [losses.mean()]
    sync()
    tracer = trace.tracer(device) if args.profile else contextlib.nullcontext()
    with tracer:
        t0 = time.perf_counter()
        for step in range(1, args.steps):
            state, losses, _ = step_fn(state, pool[step % len(pool)])
            step_losses.append(losses.mean())
        sync()
        dt = time.perf_counter() - t0
    timed = args.steps - 1
    steps_per_sec = timed / dt if timed else float("nan")
    mean_losses = torch.stack(step_losses).tolist()
    for step in range(0, args.steps, args.log_every):
        print(f"step {step}: mean loss {mean_losses[step]:.4f}")
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"ResNet-50 x{n} peers, payload {payload / 1e6:.1f} MB/exchange, "
        f"random-pair pool of {transport.schedule.pool_size}"
    )
    print(
        f"steps/sec (all {n} peers, incl. exchange, on {where} x1): "
        f"{steps_per_sec:.3f}"
    )
    return {
        "device": where,
        "n_peers": n,
        "steps": args.steps,
        "batch_size": args.batch_size,
        "image_size": s,
        "steps_per_sec": steps_per_sec,
        "images_per_sec": steps_per_sec * n * args.batch_size,
        "init_seconds": init_seconds,
        "losses": mean_losses,
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
