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

A TCP node runs the reference's recovery, health, membership, trust and
flow control planes, and its ``chaos:`` block when the config has one (its
summary line gives the trust verdicts, the planes' events, the hedges, the
rounds shed from a degraded partner, each peer's adaptive deadline, the
admission counters, the round times and the Rx server, with the reactor's
counters under ``protocol.rx_server: reactor``):
with ``DPWA_BOOTSTRAP=1`` in its environment (as a restart supervisor sets
it) it lands on a healthy peer's replica, clock and step and trains on
from that step to ``--steps``.  ``--diverge-at STEP`` turns the node's replica
and loss to NaN after that step's update (a diverged step, which the
node's guard rolls back); ``--trace-state FILE`` appends, after each
round, the step, clock and CRC-32 of the replica a peer bootstrapping from
this node would land on; ``--round-log FILE`` appends each round's exchange
(partners, remap, outcome, hedge, the scheduled partner's health state and
the round's milliseconds).  ``--barrier DIR`` serves the node's initial
replica (at clock 0) at once, starts its first round only once every node
of the config has finished its first step's computation, and keeps it
serving after its last step until every node is done, so no node's start
or end reads as a dead peer to the others.  ``--metrics FILE`` writes the
adapter's JSONL (an exchange record a round, a health record every 10, the
events); the config's ``obs:`` block turns on the round traces, sketches,
``/metrics``, incidents and the flight recorder.
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
# How long a --barrier node waits for the others, at the start and the end.
BARRIER_S = 300.0


def _barrier(directory: str, phase: str, name: str, names, timeout_s: float = BARRIER_S) -> bool:
    """Mark ``name`` as at ``phase`` in ``directory`` and wait until every
    one of ``names`` is; False when ``timeout_s`` runs out first."""
    Path(directory).mkdir(parents=True, exist_ok=True)
    Path(directory, f"{phase}.{name}").touch()
    deadline = time.monotonic() + timeout_s
    while not all(Path(directory, f"{phase}.{n}").exists() for n in names):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


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
        "--diverge-at", type=int, default=None, metavar="STEP",
        help="--transport tcp: make this node's replica and loss NaN after "
        "that step's update, as a diverged step would (the guard rolls it back)",
    )
    ap.add_argument(
        "--trace-state", metavar="FILE",
        help="--transport tcp: append one JSON line a round (step, clock, the "
        "CRC-32 of the replica in the reference's order) to FILE",
    )
    ap.add_argument(
        "--round-log", metavar="FILE",
        help="--transport tcp: append one JSON line a round (the exchange record, "
        "the scheduled partner's health state, the round's milliseconds) to FILE",
    )
    ap.add_argument(
        "--barrier", metavar="DIR",
        help="--transport tcp: serve the initial replica at once, start the rounds "
        "once every node of the config is past its first step's computation, and "
        "serve on after the last step until every node is done (a file per node "
        "and phase in DIR)",
    )
    ap.add_argument(
        "--metrics", metavar="FILE",
        help="--transport tcp: the adapter's metrics JSONL (exchange, health and "
        "event records)",
    )
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
    if (args.diverge_at is not None or args.trace_state or args.round_log or args.barrier
            or args.metrics):
        ap.error("--diverge-at, --trace-state, --round-log, --barrier and --metrics need "
                 "--transport tcp")

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


def _leaders(transport):
    """Each island's leader and term on the node's board (None: a flat
    ring, or membership off)."""
    board = None if transport.membership is None else transport.membership.leader_board
    if board is None:
        return None
    return {board.topology.island_name(g): [leader, board.term_of(g)]
            for g, leader in board.leaders().items()}


def run_tcp(args) -> dict:
    """One node of the TCP deployment (the reference's ``run_tcp``):
    train this node's replica and gossip it every step; returns the
    node's losses, test accuracy, rate, merged rounds, fetch outcomes, wire
    bytes and the wire's snapshot, host copies per received frame, B2's and
    the quantiser's launches and peak device memory, and its recovery and health: the bootstrap it landed on, its
    rollbacks, remapped rounds, header and relay probes sent and each change of a
    peer's health state with the step it was seen at; and its membership
    and trust planes: the trust verdicts, the merged rounds and newest
    merged publish clock per peer, the rounds that fetched each peer, the
    digest bytes a frame, the fetched digests' versions and the
    membership, trust and heal events with their steps; and under a
    ``topology:`` block each island's leader and term."""
    import zlib

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
    adapter = DpwaTcpAdapter(params, args.name, cfg, transport=bundle.transport,
                             metrics=args.metrics)
    params = adapter.params
    flat = adapter.flat
    start = adapter.step  # 0, or the donor's step after a bootstrap

    def replica_crc() -> int:
        return zlib.crc32(adapter.vector().cpu().numpy())

    if adapter.last_bootstrap is not None:
        print(json.dumps({"node": args.name, "bootstrap": {
            **adapter.last_bootstrap, "crc32": replica_crc()}}), flush=True)
    if args.barrier:
        # A node still in its first step serves its initial replica.
        adapter.transport.publish(adapter.vector(), adapter.clock, 0.0)
    trace = open(args.trace_state, "a") if args.trace_state else None
    round_log = open(args.round_log, "a") if args.round_log else None
    sb = adapter.transport.scoreboard
    peer_state = {p: "healthy" for p in range(cfg.n_peers) if p != me}
    health_events, remapped, shed, hedged, round_ms = [], 0, 0, 0, []
    fetched_from: dict = {}  # peer -> rounds that fetched it
    opt = adam(args.lr)
    opt_state = opt.init(flat.flat)

    def loss_fn(p, xb, yb):
        logits = torch.func.functional_call(model, p, (xb,))
        return softmax_cross_entropy_with_integer_labels(logits, yb).mean()

    grad_fn = torch.func.grad_and_value(loss_fn)
    rng = np.random.default_rng(1000 + me)
    from dpwa_tpu_torch.ops import quantize

    def b2_launches() -> int:  # B2's forms that merge a row: one a merged round
        return (merge.gather_merge.launches + merge.int8_frame_merge.launches
                + merge.topk_merge.launches)

    launches0 = b2_launches()
    topk0, quantize0 = merge.topk_merge.launches, quantize.quantize_sr.launches
    int8_form0, fold0 = merge.int8_frame_merge.launches, merge.fold_merge.launches
    losses = []
    t0 = None
    try:
        for step in range(start, args.steps):
            if step == start + 1:  # the first step (the kernels' build and load) untimed
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
            idx = torch.from_numpy(rng.integers(0, len(xs[me]), size=args.batch_size)).to(device)
            grads, loss = grad_fn(params, x_my[idx], y_my[idx])
            updates = opt.update_(flat.pack({k: g[None] for k, g in grads.items()}), opt_state)
            flat.add_(updates)
            loss = float(loss)
            if step == args.diverge_at:
                flat.flat.fill_(float("nan"))
                loss = float("nan")
            if step == start and args.barrier:
                # The first rounds start together, once every node is past the
                # slow first step: its first frames are no node's initial one.
                if not _barrier(args.barrier, "ready", args.name, cfg.node_names):
                    raise RuntimeError(f"{args.name}: not every node of {cfg.node_names} came up")
            t_round = time.perf_counter()
            params = adapter.update(loss)
            round_ms.append((time.perf_counter() - t_round) * 1e3)
            losses.append(loss)
            rec = adapter.last_record
            if rec.get("outcome") is not None and rec.get("partner") not in (None, me):
                fetched_from[rec["partner"]] = fetched_from.get(rec["partner"], 0) + 1
            remapped += bool(rec.get("remapped"))
            hedged += bool(rec.get("hedged"))
            # The scheduled partner's state as the round began.
            sched_state = peer_state.get(rec.get("sched_partner"))
            shed += bool(rec.get("remapped")) and sched_state == "degraded"
            if round_log is not None:
                round_log.write(json.dumps({**rec, "sched_state": sched_state,
                                            "round_ms": round_ms[-1]}) + "\n")
            if sb is not None:
                for p, was in peer_state.items():
                    now = sb.state(p)
                    if now != was:
                        health_events.append({"step": step, "peer": p, "state": now})
                        peer_state[p] = now
            if trace is not None:
                trace.write(json.dumps({"step": adapter.step, "clock": adapter.clock,
                                        "crc32": replica_crc()}) + "\n")
            if step % args.log_every == 0:
                print(json.dumps({"step": step, "node": args.name, "loss": loss,
                                  "alpha": adapter.last_alpha, "partner": adapter.last_partner,
                                  "merged": adapter.transport.stats["merged"]}),
                      flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0 if t0 is not None else float("nan")
        with torch.no_grad():
            logits = torch.func.functional_call(model, params, (torch.from_numpy(x_te).to(device),))
        acc = float((logits.argmax(-1).cpu().numpy() == y_te).mean())
        print(f"[{args.name}] {dataset} test accuracy: {acc:.4f}", flush=True)
        stats = adapter.transport.stats
        timed = args.steps - start - 1
        hsnap = adapter.transport.health_snapshot()
        fsnap = hsnap.get("flowctl")
        result = {
            "node": args.name,
            "dataset": dataset,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "steps": args.steps,
            "start_step": start,
            "steps_per_sec": timed / dt if timed > 0 else float("nan"),
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
            "b2_launches": b2_launches() - launches0,
            # of them B2's int8-frame form (one a merged int8 round) and its
            # top-k form (one a merged top-k or shard-top-k round); then the
            # int8 quantiser (one an int8 publish, a top-k one with int8 values)
            "int8_frame_launches": merge.int8_frame_merge.launches - int8_form0,
            "topk_launches": merge.topk_merge.launches - topk0,
            "quantize_launches": quantize.quantize_sr.launches - quantize0,
            # B2's fold form: one a drained run of two or more dense frames
            # under protocol.async_rounds
            "fold_launches": merge.fold_merge.launches - fold0,
            "wire": adapter.transport.wire_snapshot(),
            # The Rx server (threaded, reactor, or the chaos harness's) and,
            # under the reactor, its scheduler's counters.
            "rx_server": type(adapter.transport.server).__name__,
            "reactor": hsnap.get("reactor"),
            "peak_memory_bytes": (
                torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
            ),
            "bootstrap": adapter.last_bootstrap,
            "rollbacks": adapter.ring.rollbacks if adapter.ring is not None else 0,
            "last_rollback": adapter.last_rollback,
            "remapped_rounds": remapped,
            "probes": stats["probes"],
            "relay_probes": stats["relay_probes"],
            "health_events": health_events,
            "verdicts": dict(stats["verdicts"]),
            "merged_from": {str(p): v for p, v in stats["merged_from"].items()},
            "fetched_from": {str(p): v for p, v in sorted(fetched_from.items())},
            "digest_bytes": adapter.transport.last_digest_nbytes,
            # digest version -> fetched frames that carried one (2: the
            # hierarchical digest of a topology: block)
            "digest_versions": {str(v): n for v, n in sorted(stats["digest_versions"].items())},
            # The leader board of a topology: block, island -> [leader, term]
            "leaders": _leaders(adapter.transport),
            "events": list(adapter.events),
            "hedged_rounds": hedged,
            "shed_rounds": shed,
            # protocol.async_rounds: merges, drops, folds, and the receive-ring
            # bytes the queues held at their peak
            "async": (None if adapter.transport.async_engine is None else {
                k: v for k, v in adapter.transport.async_engine.snapshot().items()
                if k != "peers"}),
            "flowctl": None if fsnap is None else {
                "hedges": fsnap["hedges"], "hedge_wins": fsnap["hedge_wins"],
                **{key: {str(p): v[key] for p, v in fsnap["peers"].items()}
                   for key in ("deadline_ms", "busy", "slow")},
                "admission": fsnap.get("admission"),
            },
            # The rounds' wall time (adapter.update: publish, fetch, guard,
            # screen, merge), the first (the build) left out.
            "round_ms": dict(zip(("p50", "p90", "p99", "max"), (
                float(np.percentile(round_ms[1:], q)) for q in (50, 90, 99, 100)
            ))) if len(round_ms) > 1 else None,
        }
        if args.barrier:
            # Serve on until every node is done: no node's end is a dead peer.
            _barrier(args.barrier, "done", args.name, cfg.node_names)
    finally:
        if trace is not None:
            trace.close()
        if round_log is not None:
            round_log.close()
        adapter.close()
    return result


if __name__ == "__main__":
    out = main()
    if out.get("node") is not None:  # a tcp node: its counts, one JSON line
        print(json.dumps({k: v for k, v in out.items() if k != "losses"}))
