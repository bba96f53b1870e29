#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``dpwa_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``dpwa_tpu_torch/ops/csrc`` (set-up
time, one ``nvcc`` per source, all started together), holds the merge
kernels bit for bit against their plain PyTorch versions on a CPU copy of
the same inputs (both forms: the partner's row from x, and from the wire
buffer w) and the flash-attention kernels against theirs on the card
within a stated tolerance, at the main paths' shapes, times each on the
card, and runs the card tests.  Then it drives the main paths and checks
that they went through the kernels:

- ``dpwa_tpu_torch.examples.cifar10``: 8 peers, ResNet-20 at full width,
  ring gossip on the CIFAR-10 fixture — pairwise (B1), in pull mode (B2)
  and once more under the profiler; and with partial participation and
  injected faults on the int8 wire, pairwise and pull (the wire forms of
  B1 and B2), each step's participation held against the host's draws;
- ``dpwa_tpu_torch.examples.mnist`` (BASELINE config 1 on the stacked
  transport): 2 peers of SmallNet on the 8×8 digits fixture, ring, Adam,
  300 steps (B1 once a step), once more under the profiler, and a 14-step
  run saved at step 10 and resumed from there, which must land on the
  straight run's state bit for bit (as must a second straight run);
- ResNet-20 with BatchNorm, 8 peers on the CIFAR-10 fixture, through the
  stacked step with model state: the parameters and the running statistics
  merged by one B1 launch a step;
- ``dpwa_tpu_torch.examples.mnist --transport tcp`` (BASELINE config 1 as
  the reference deploys it): two OS processes, one per node of a copy of
  ``examples/mnist/nodes.yaml`` on two free ports, SmallNet, 300 steps,
  each replica on the card and every fetched frame merged there by one B2
  launch over ``[1, 66410]``, at the default planes (membership, trust and
  flowctl on: every frame carries its digest and is screened, every fetch
  runs on its adaptive deadline); four processes of a 4-node copy whose
  node2 the chaos harness trickles at 2048 B/s for a window of its publish
  clocks, which its partners must soft-degrade (hedging and shedding its
  rounds to a fallback) and never quarantine; three processes of
  a 4-node copy and a byzantine fourth node serving sign-flips, which the
  honest nodes must reject, quarantine and never merge; the trust screen
  at 66,410 and 25,557,032 floats against its float64 plain version; the
  same pair with node1's step made NaN,
  which its guard rolls back to its ring on the card; the same pair with
  node1 killed (SIGKILL) and restarted with ``DPWA_BOOTSTRAP=1``, which
  node0 must quarantine, probe and readmit and node1 must land on node0's
  published step, clock and replica; the TCP exchange itself as
  ``bench.py`` times it (2 nodes in one process, lock-step) with
  device-resident replicas of ResNet-50's 25,557,032 parameters on the f32
  and bf16 wires, and the f32 round under the threaded and the reactor Rx
  server in turns, split into the fetch and what follows it; the recovery
  plane's pieces at that size (the state's pack, transfer, unpack and
  landing, the ring, the guard); 16 nodes in this process on the reactor,
  each a SmallNet replica on the card, under a bounded partial view with
  one node closed early (its neighbours remap over their active views,
  evict it and promote a passive peer; digests, caps and fetches checked),
  and the same run view-off and at the identity view, whose frames must be
  equal; the MNIST pair and the byzantine group again on the reactor; the
  MNIST pair with the whole observability plane on (round traces joined
  across the nodes, sketches, ``/metrics``, a clean run's incident report,
  the flight recorder's dumps, the adapter's metrics files, each checked
  by the repo's tools); and the f32 exchange with the plane off and on in
  turns (each on frame the off frame plus its ``DPWT`` trailer, the merges
  bit-equal, the round split by stage, the sketch on the card against its
  bound) and under the traced prefetch pipeline; eight processes of an
  8-node copy split by a ``topology:`` block into two islands of four,
  whose boards must elect node3 and node4 and whose only cross-island
  fetches must be those two leaders' wide slots, every frame with a v2
  digest; and the hierarchical gossip simulator with its replicas on the
  card (64 peers, the flat ring and islands of 4, 8 and 16, then a leader
  killed), its frames and replicas held against its run on the CPU;
- ``dpwa_tpu_torch.examples.imagenet``: 32 peers of ResNet-50 at full
  width and depth (25,557,032 parameters a peer), 224×224, batch 4 a peer,
  the random schedule (pool 32), f32 wire (B1 over 3.27 GB a step) — once
  timed and once under the profiler;
- ``dpwa_tpu_torch.examples.llama_lora``: 4 peers at Llama-3-8B width with
  the depth cut to 2 layers, LoRA rank 8, T = 2048, the random schedule,
  Adam, the LoRA-only exchange (B1) and flash attention (B5) — once timed
  and once under the profiler;
- ``dpwa_tpu_torch.examples.bert``: 16 peers of BERT-base at full width
  and depth (132,953,658 parameters a peer, 8.51 GB for 16), T 128, batch 8
  a peer, the hierarchical schedule (groups of 8, every 4th step across
  groups), AdamW, f32 wire (B1 over the whole model) — once timed and once
  under the profiler;
- ``dpwa_tpu_torch.examples.longcontext``: 2 peers at Llama-3-8B width, 2
  layers, LoRA rank 8, each peer's T = 8192 over a virtual sequence-parallel
  axis of 4 ranks, the ring schedule, Adam, the LoRA-only exchange (B1):
  the ring with the contiguous and the zigzag layout (the hop kernels B3
  and B4), Ulysses (B5 per rank), and the contiguous ring once more under
  the profiler.

One JSON line per phase; the kernel table and the card's name and power
limit come on the lines before the last, and the last line is the result.
Any failed phase exits nonzero without a result line, as does a machine
without a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
MAIN_D = 272474  # ResNet-20's parameters per peer: the main path's row
BIG_D = 24 * 2**20  # bench.py's default exchange size
N_PEERS = 8
R50_D = 25557032  # ResNet-50's parameters per peer: the ImageNet path's row
R50_PEERS = 32
WIRES = ("f32", "bf16", "int8")  # the merge kernels' arithmetic forms
ALL_PHASES = (
    "b1", "b2", "b5", "b3", "b4", "card_tests", "train", "train_pull", "profile",
    "train_mnist", "profile_mnist", "resume_mnist", "train_bn", "train_tcp", "slowpeer_tcp",
    "trust_screen", "byzantine_tcp", "tcp_exchange", "rollback_tcp", "recover_tcp", "state_exchange",
    "codec_kernels", "wire_exchange", "codecs_tcp", "fold_kernels", "overlap_tcp", "async_tcp",
    "view_tcp", "reactor_tcp", "reactor_exchange", "obs_tcp", "obs_exchange",
    "hier_tcp", "hier_engine", "train_draws", "train_draws_pull", "train_imagenet", "profile_imagenet",
    "train_bert", "profile_bert", "train_llama", "profile_llama", "train_sp",
    "train_sp_zigzag", "train_sp_a2a", "profile_sp",
)
# Phases run only when --phases names them (not by default).
EXTRA_PHASES = ("train_tcp_planes",)
# train_tcp_planes: train_tcp with the membership, trust and flowctl planes
# on and off, the variants in turns (ABCDE EDCBA, PLANES_REPS times over).
PLANE_VARIANTS = {
    "defaults": "",
    "trust_off": "trust: {enabled: false}\n",
    "membership_off": "membership: {enabled: false}\n",
    "both_off": "membership: {enabled: false}\ntrust: {enabled: false}\n",
    "flowctl_off": "flowctl: {enabled: false}\n",
}
PLANES_REPS = 2
# The MNIST path (BASELINE config 1, stacked): 2 peers of SmallNet on the
# digits, 66,410 parameters a peer; the resume check's run and save step.
MNIST_D, MNIST_PEERS, MNIST_STEPS = 66410, 2, 300
RESUME_STEPS, RESUME_SAVE = 14, 10
# The TCP path (BASELINE config 1 as the reference deploys it): two OS
# processes of the MNIST example, one per node of examples/mnist/nodes.yaml,
# on the one card; the exchange bench at ResNet-50's vector (bench.py's TCP
# leg: 3 warm-up rounds, then 3 passes of 10, median of the pass medians).
TCP_TIMEOUT_S = 420
# The recovery phases: node1 of the MNIST TCP pair killed once it has
# merged this many rounds, then restarted to bootstrap from node0 (both run
# RECOVER_STEPS steps, enough for node0 to outlast the restart); each must
# merge at least RECOVER_MIN_MERGED rounds after it; node1's step made NaN
# at ROLLBACK_AT.
RECOVER_STEPS, RECOVER_KILL_MERGED, RECOVER_MIN_MERGED, ROLLBACK_AT = 4000, 50, 100, 150
TCP_WARMUPS, TCP_PASSES, TCP_ITERS = 3, 3, 10
# The byzantine phase: examples/mnist/nodes.yaml widened to 4 nodes; node0-2
# are processes of the MNIST example, node3 a TcpTransport of this script
# that serves the replica it last fetched and, once both its ring partners
# (node0 and node2) have served a clock of BYZ_FLIP_AFTER or more (their
# trust screens armed), that replica's sign-flip.  It paces its rounds at
# BYZ_ROUND_S.  The honest nodes train on a quarter of the digits each and
# run BYZ_STEPS steps.
BYZ_NODES, BYZ_FLIP_AFTER, BYZ_ROUND_S, BYZ_STEPS = 4, 60, 0.005, 600
# The slow-peer phase: examples/mnist/nodes.yaml widened to 4 nodes, all
# processes of the MNIST example at the default planes; the chaos harness
# trickles node SLOW_VICTIM's serving at the reference's default 2048 B/s
# (a 265,640-byte frame would take about 130 s) for its publish clocks
# SLOW_WINDOW; SLOW_STEPS steps, the nodes held at a start and an end
# barrier so that no node's start or end reads as a dead peer.
SLOW_NODES, SLOW_VICTIM, SLOW_WINDOW, SLOW_STEPS = 4, 2, (150, 450), 600
SLOW_CHAOS = (
    "chaos:\n  enabled: true\n  seed: 5\n  trickle_bytes_per_s: 2048.0\n"
    f"  trickle_windows: [[{SLOW_VICTIM}, {SLOW_WINDOW[0]}, {SLOW_WINDOW[1]}]]\n"
)
# The TCP wire's codecs: bench.py's wire and shard sweeps (WIRE_SWEEP_CODECS,
# SHARD_SWEEP_KS on f32 and topk 0.05) on the card at ResNet-50's d, plus the
# int8 wire with the guard and the screen off (no dequantised copy: the
# merge alone reads the frame), 2 warm-up rounds and 2 passes of 5; and the
# MNIST example over TCP under int8, topk 0.05 and shard k 4 (int8 and topk
# inners), with examples/mnist_torch.py on the int8 wire beside them.
WIRE_LEGS = (
    ("f32", {}), ("bf16", {"wire_dtype": "bf16"}), ("int8", {"wire_dtype": "int8"}),
    ("topk_0.1", {"wire_codec": "topk", "topk_fraction": 0.1}),
    ("topk_0.05", {"wire_codec": "topk", "topk_fraction": 0.05}),
    *((f"shard{k}_f32", {"shard": {"k": k}}) for k in (2, 4, 8)),
    *((f"shard{k}_topk_0.05", {"shard": {"k": k}, "wire_codec": "topk", "topk_fraction": 0.05})
      for k in (2, 4, 8)),
    ("int8_unjudged", {"wire_dtype": "int8", "recovery": {"enabled": False},
                       "trust": {"enabled": False}}),
)
WIRE_WARMUPS, WIRE_PASSES, WIRE_ITERS = 2, 2, 5
# B2's top-k form in codec_kernels: (name, topk fraction, shard count; the
# last shard's slice when more than 1), at ResNet-50's d.
TOPK_MERGE_CASES = (("topk_0.05", 0.05, 1), ("topk_0.1", 0.1, 1), ("shard4_topk_0.05", 0.05, 4))
CODEC_RUNS = {  # name: (protocol lines, top-level blocks)
    "int8": ("  wire_dtype: int8\n", ""),
    "topk": ("  wire_codec: topk\n  topk_fraction: 0.05\n", ""),
    "shard4_int8": ("  wire_dtype: int8\n", "shard: {k: 4}\n"),
    "shard4_topk": ("  wire_codec: topk\n  topk_fraction: 0.05\n", "shard: {k: 4}\n"),
}
# The fan-in and barrier-free slice: B2's fold form at ResNet-50's d for
# these run lengths k (its bound (k + 2)·4·d bytes), and the fan-in round of
# FAN_IN_NODES nodes there; bench.py's overlap leg (bench_wire: 2 nodes, f32,
# the prefetch pipeline under a compute stand-in the size of the lock-step
# exchange) at that d, OVERLAP_ITERS rounds a leg; bench.py's bench_async at
# its defaults (4 nodes, d 4096, the last trickled at 2048 B/s, 24 rounds,
# a 400 ms timeout, 30 ms of compute a round); then the MNIST example over
# TCP with the pipeline (2 processes) and with async rounds (4 processes).
FOLD_KS, FAN_IN_NODES, OVERLAP_ITERS = (2, 4, 8), 4, 12
ASYNC_NODES, ASYNC_D, ASYNC_ITERS, ASYNC_TIMEOUT_MS = 4, 4096, 24, 400
ASYNC_TRICKLE, ASYNC_COMPUTE_MS = 2048.0, 30.0
OVERLAP_PROTOCOL = "  overlap_prefetch: true\n"
ASYNC_PROTOCOL = "  async_rounds: {enabled: true}\n"
# The partial view and the reactor: view_tcp runs VIEW_NODES TcpTransports
# in this process on the reactor, each a SmallNet replica on the card drawn
# from --seed, the ring schedule and the default planes under VIEW; node
# VIEW_CLOSED closes at round VIEW_CLOSE_AT (its ring neighbours remap over
# their active views, then evict it as dead, which promotes a passive peer);
# VIEW_ROUNDS lock-step rounds (set from a CPU rehearsal: the dead
# evictions land at rounds 39-46 there and on the card); the same run
# view-off and at VIEW_IDENTITY must publish the same frames.  reactor_tcp
# reruns train_tcp and byzantine_tcp at once with REACTOR_PROTOCOL (the
# byzantine rerun with a chaos block that draws no fault, so every node
# serves from the chaos reactor); reactor_exchange times tcp_exchange's f32
# round under each Rx server in turns (REACTOR_ORDER), each leg
# REACTOR_WARMUPS rounds and REACTOR_PASSES passes of REACTOR_ITERS.
VIEW_NODES, VIEW_CLOSED, VIEW_CLOSE_AT, VIEW_ROUNDS = 16, 7, 5, 54
VIEW = {"active_size": 4, "passive_size": 4, "digest_sample": 4, "state_cap": 8,
        "shuffle_every": 8}
VIEW_IDENTITY = dict(VIEW, active_size=15, digest_sample=16, state_cap=16)
REACTOR_PROTOCOL = "  rx_server: reactor\n"
REACTOR_CHAOS = "chaos: {enabled: true, seed: 0}\n"
REACTOR_ORDER = ("threaded", "reactor", "reactor", "threaded", "threaded", "reactor")
REACTOR_WARMUPS, REACTOR_PASSES, REACTOR_ITERS = 2, 2, 5
# The observability plane: obs_tcp runs train_tcp's two MNIST processes with
# start and end barriers, every facility of OBS_TCP on (the round traces,
# the sketch, /metrics, the incident plane, the flight recorder; each
# node's files named in a config of its own) and the adapter's metrics
# JSONL; obs_exchange runs tcp_exchange's lock-step f32 round at
# ResNet-50's d with the obs block off and OBS_EXCHANGE on in turns
# (OBS_ORDER), each leg OBS_WARMUPS warm-up rounds and OBS_ROUNDS timed,
# then one leg of the prefetch pipeline, traced, under a compute stand-in
# the size of the off legs' median round.
OBS_TCP = ("obs: {{trace: true, sketch: true, metrics: true, incidents: true, "
           "recorder: true, trace_path: '{trace}', incident_path: '{incidents}', "
           "recorder_path: '{flight}'}}\n")
OBS_EXCHANGE = {"trace": True, "sketch": True, "metrics": True}
OBS_ORDER = ("off", "on", "on", "off")
OBS_WARMUPS, OBS_ROUNDS = 1, 4
OBS_SKETCH_K = 64  # ObsConfig.sketch_k's default
OBS_STAGES = ("publish", "partner_resolve", "wire", "guard", "trust", "merge")
OBS_PIPE_STAGES = ("join_wait", "decode", "guard", "trust", "merge", "publish")
OBS_FAMILIES = ("dpwa_peer_state", "dpwa_membership_incarnation", "dpwa_trust_score",
                "dpwa_flowctl_deadline_ms", "dpwa_admission_sheds_total", "dpwa_wire_frames_total",
                "dpwa_disagreement_rms", "dpwa_trace_stage_seconds_total")
# Hierarchical gossip: hier_tcp runs HIER_NODES MNIST processes (start and
# end barriers) on a copy of examples/mnist/nodes.yaml with HIER_TOPOLOGY
# (docs/hierarchy.md's layout: leaders node3 and node4 at leader_seed 0, a
# wide-area slot every third step); hier_engine runs the simulator at
# bench.py --hier-leg's defaults (HIER_PEERS peers, islands of each of
# HIER_SIZES, HIER_ROUNDS rounds, target HIER_TARGET, seed 0) with replicas
# of MNIST_D floats on the card and on the CPU, then the leader-kill
# episode of tests/test_hier.py (2 islands of 4, the leader of island 1
# killed after round HIER_KILL_AT, HIER_KILL_ROUNDS rounds).
HIER_NODES = 8
HIER_TOPOLOGY = (
    "topology:\n  islands:\n    - {name: pod-a, nodes: [node0, node1, node2, node3]}\n"
    "    - {name: pod-b, nodes: [node4, node5, node6, node7]}\n"
    "  leader_seed: 0\n  intra_rounds: 1\n"
)
HIER_LEADERS = {"pod-a": [3, 0], "pod-b": [4, 0]}
HIER_PEERS, HIER_SIZES, HIER_ROUNDS, HIER_TARGET = 64, (4, 8, 16), 64, 0.05
HIER_KILL_AT, HIER_KILL_ROUNDS = 3, 10
# The trust screen at the TCP paths' replicas: (name, d, the leaves' model).
SCREEN_CASES = (("smallnet", MNIST_D, "mnist"), ("resnet50", R50_D, "resnet50"))
SCREEN_RTOL = 1e-5  # norm_ratio and update_ratio; cosine within 1e-5 absolute
# The BatchNorm path: ResNet-20's parameters and, right after them in each
# row, its 1,568 running statistics; 5 steps.
BN_D, BN_STEPS = MAIN_D + 1568, 5
# The ImageNet path: 32 peers of ResNet-50 at 224×224, batch 4 a peer.
IMAGENET_BATCH, IMAGENET_STEPS = 4, 6
# The BERT path: 16 peers of BERT-base (BASELINE config 4, 64 peers cut to
# 16), two groups of 8, every 4th step across groups, T 128, batch 8 a peer.
BERT_D = 132953658  # BERT-base's parameters per peer: the BERT path's row
BERT_PEERS, BERT_GROUP, BERT_INTER, BERT_T, BERT_BATCH, BERT_STEPS = 16, 8, 4, 128, 8, 6
BERT_VOCAB = 30522
# The draws path: the ResNet-20 example with partial participation and
# injected faults on the int8 wire.
DRAWS = {"fetch_probability": 0.5, "drop_probability": 0.1, "steps": 5}
# The Llama path: 4 peers of Llama-3-8B width, 2 layers, batch 1, T 2048.
LLAMA_PEERS, LLAMA_LAYERS, LLAMA_T, LLAMA_STEPS = 4, 2, 2048, 6
# B5 at the path's shapes ([n·B, T, H, D] q, [n·B, T, KV, D] k and v) and
# more: non-causal, a shorter T with full (ungrouped) k and v, and q scaled
# by 8 (large scores, a nearly one-hot softmax).  (name, B, T, H, KV,
# causal, q scale)
B5_CASES = (
    ("main", 4, 2048, 32, 8, True, 1.0),
    ("non_causal", 4, 2048, 32, 8, False, 1.0),
    ("short_full_kv", 4, 384, 32, 32, True, 1.0),
    ("main_q8", 4, 2048, 32, 8, True, 8.0),
    ("non_causal_q8", 4, 2048, 32, 8, False, 8.0),
)
B5_TOL = {"fwd": 1e-5, "bwd": 1e-4}  # normwise: max|Δ| / max(1, max|plain|)
# The sequence-parallel path: 2 peers of Llama-3-8B width, 2 layers, batch 1,
# T 8192 over a virtual axis of 4 ranks (T_local 2048).  B3/B4 run at its
# shapes: q [2, 8192, 32, 128], k and v [2, 8192, 8, 128].
SP_PEERS, SP_SIZE, SP_T, SP_STEPS = 2, 4, 8192, 4
SP_PHASES = {  # phase: (layout, strategy, steps, profiled)
    "train_sp": ("contiguous", "ring", SP_STEPS, False),
    "train_sp_zigzag": ("zigzag", "ring", SP_STEPS, False),
    "train_sp_a2a": ("contiguous", "a2a", SP_STEPS, False),
    "profile_sp": ("contiguous", "ring", 3, True),
}


OUT = []  # files that also get every emitted line (--out)
# The forward kernel (B3, B5's forward) and the backward kernels, storing
# (B5) and adding (B4): all on the tensor cores.
FWD_KERNEL = "fwd_kernel<128>"
BWD_KERNELS = {
    add: (f"dkdv_kernel<128, {str(add).lower()}>", f"dq_kernel<128, {str(add).lower()}>")
    for add in (False, True)
}


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    for f in OUT:
        f.write(line + "\n")
        f.flush()


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound_3xtf32_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    """The bound of float32 work done on the tensor cores in 3xTF32, three
    TF32 products for each float32 one (the backward kernels' design)."""
    return bound_ms(n_bytes, 3 * flops, TF32_FLOPS_PER_S)


def kernel_name(mangled: str) -> str:
    """``dkdv_kernel<128, true>`` from the mangled name of a kernel in an
    anonymous namespace (other names come back as they are)."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)
    if not m:
        return mangled
    start = m.start(1) + len(m.group(1)) + int(m.group(1))  # past the namespace's name
    m = re.match(r"\d+", mangled[start:])
    if not m:
        return mangled
    end = start + m.end() + int(m.group(0))
    name, rest = mangled[start + m.end():end], mangled[end:]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if not args:
        return name
    vals = [v if t == "i" else ("true" if v == "1" else "false")
            for t, v in re.findall(r"L([ib])(\d+)E", args.group(1))]
    return f"{name}<{', '.join(vals)}>"


def ptxas_kernels(log: str) -> dict:
    """Each kernel's registers and spill bytes from ``nvcc -Xptxas -v``."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = kernel_name(m.group(1))
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


def sass_counts(lib_path) -> dict:
    """Per kernel of a built library, from ``cuobjdump -sass``: its TF32
    tensor-core instructions and its float32 FMAs."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    counts, current = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = kernel_name(m.group(1))
            counts[current] = {"hmma_tf32": 0, "ffma": 0}
        elif current is not None:
            if re.search(r"\bHMMA\S*TF32", line):
                counts[current]["hmma_tf32"] += 1
            elif re.search(r"\bFFMA\b", line):
                counts[current]["ffma"] += 1
    return counts


def time_ms(torch, fn, iters: int, flush) -> float:
    """Mean device time of one call of ``fn`` from CUDA events, with the L2
    cache flushed before each call (the exchange finds its buffer cold).
    The events bracket only the call: the flush before it keeps the card
    busy while the host enqueues, so host time does not show as device
    time."""
    fn()
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def padded_rows(torch, cpu: "torch.Tensor", device):
    """``cpu`` ([n, d]) on the card with its rows padded to 32 floats: the
    flat parameter buffer's layout, which the ResNet path gives the kernels.
    The other row layouts the kernels take are in tests/test_torch_card.py."""
    n, d = cpu.shape
    buf = torch.zeros(n, -(-d // 32) * 32, dtype=torch.float32, device=device)
    view = buf[:, :d]
    view.copy_(cpu)
    return view


def llama_config():
    """The Llama path's model: Llama-3-8B width, LoRA rank 8, depth cut."""
    from dpwa_tpu_torch.models import llama

    return dataclasses.replace(llama.llama3_8b_config(lora_rank=8), n_layers=LLAMA_LAYERS)


def llama_lora_layout() -> tuple[int, int]:
    """(row stride, LoRA width) of the Llama path's flat buffer: its rows
    hold the whole model (about 1.49e9 floats) with the LoRA leaves placed
    first, in one column range of that width, which B1 merges."""
    from dpwa_tpu_torch.models import llama
    from dpwa_tpu_torch.utils.pytree import ROW_ALIGN

    shapes = llama.param_shapes(llama.Llama(llama_config()))
    size = sum(math.prod(shape) for shape in shapes.values())
    width = sum(math.prod(shape) for name, shape in shapes.items() if llama.lora_filter(name))
    return -(-size // ROW_ALIGN) * ROW_ALIGN, width


def llama_lora_rows(torch, cpu: "torch.Tensor", device):
    """``cpu`` ([LLAMA_PEERS, width]) on the card as the Llama path gives it
    to B1: the LoRA column range of its flat buffer.  Only the storage up to
    the last row's slice is allocated (18 GB)."""
    ld, width = llama_lora_layout()
    if tuple(cpu.shape) != (LLAMA_PEERS, width):
        raise ValueError(f"llama_lora_rows: {tuple(cpu.shape)} is not [{LLAMA_PEERS}, {width}]")
    view = torch.empty_strided(cpu.shape, (ld, 1), dtype=torch.float32, device=device)
    view.copy_(cpu)
    return view


def sat_out_rows(perm) -> list[int]:
    """The rows that sit the round out: the fixed points of ``perm``."""
    return [i for i, p in enumerate(perm) if p == i]


def poison(x: "torch.Tensor", rows) -> None:
    """Put inf, -inf, NaN, -0.0 and 3e38 at both ends of ``rows``."""
    bad = x.new_tensor([math.inf, -math.inf, math.nan, -0.0, 3.0e38])
    for i in rows:
        x[i, :5] = bad
        x[i, -5:] = bad


def nan_equal(torch, got, want) -> tuple[bool, float]:
    """(equal, max_abs_err): every element has the same bits, or both are
    NaN (the card and the CPU make NaNs with different payloads)."""
    both_nan = got.isnan() & want.isnan()
    same = (got.view(torch.int32) == want.view(torch.int32)) | both_nan
    diff = (got - want).abs()
    diff[both_nan | (got == want)] = 0.0
    return bool(same.all()), float(diff.max())


def resnet_shapes(imagenet: bool, device) -> dict:
    """``{name: shape}`` of ResNet-20's or ResNet-50's parameters."""
    from dpwa_tpu_torch.models import resnet

    model = resnet.ResNet50(device=device) if imagenet else resnet.ResNet20()
    return {name: tuple(p.shape) for name, p in model.named_parameters()}


def fake_quant_ms(torch, merge, shapes: dict, peers: int, device, iters: int) -> float:
    """Device time of the int8 wire's fake quantisation of every peer's row
    (:func:`~dpwa_tpu_torch.ops.quantize.fake_quant_rows`, the threefry
    draws included) over a flat buffer of these leaves, from CUDA events."""
    from dpwa_tpu_torch.ops.quantize import WirePlan, fake_quant_rows
    from dpwa_tpu_torch.utils.pytree import FlatParams, leaf_order

    names = leaf_order(shapes)
    flat = FlatParams(names, [shapes[k] for k in names], peers, device=device)
    flat.flat.normal_()
    w = merge.empty_rows_like(flat.flat)
    plan = WirePlan(flat.leaf_ranges(), device)
    flush = torch.empty(1, device=device)
    ms = time_ms(torch, lambda: fake_quant_rows(flat.flat, w, plan, 0, 1), iters, flush)
    del flat, w, plan
    torch.cuda.empty_cache()
    return ms


def random_sat_out_map(peers: int):
    """Row 0 of the ImageNet path's random pool (32 peers, pool 32) with its
    first two pairs broken up, so that four peers sit the round out."""
    import numpy as np

    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.parallel import schedules

    perm = schedules.build_schedule(
        make_local_config(peers, schedule="random", pool_size=32)
    ).pool[0].copy()
    for i in [i for i in range(peers) if i < perm[i]][:2]:
        perm[perm[i]] = perm[i]
        perm[i] = i
    assert schedules.is_involution(perm) and len(sat_out_rows(perm)) == 4
    return perm


def bert_map():
    """Row 0 of the BERT path's hierarchical pool (16 peers, groups of 8):
    an intra-group matching, what three steps in four merge with."""
    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.parallel import schedules

    return schedules.build_schedule(make_local_config(
        BERT_PEERS, schedule="hierarchical", group_size=BERT_GROUP, inter_period=BERT_INTER,
    )).pool[0].copy()


def kernel_checks(torch, merge, device, flush, kind: str) -> dict:
    """B1 (kind "b1") or B2 (kind "b2"): bit-equality against the plain
    version on CPU copies, then times.  Both forms: the partner's value from
    x, and the wire form, from a second buffer w of the same layout (the
    int8 wire's dequantized rows), each in the f32, bf16 and int8 wires'
    arithmetic.  B2 and B1 at the ResNet-20 path's padded ``[8, 272474]``
    rows (every map), at bench.py's ``[8, 24·2^20]`` (the wire form's map)
    and at the ImageNet path's ``[32, 25557032]``
    (ResNet-50, 3.27 GB); B1 also at the Llama path's ``[4, 1310720]`` LoRA
    column slice, at the BERT path's ``[16, 132953658]`` (8.51 GB, the
    hierarchical schedule's intra-group matching, f32 wire), at the MNIST
    path's ``[2, 66410]`` and at the BatchNorm path's ``[8, 274042]``
    (ResNet-20's parameters and running statistics in one row).  B1 runs as the main paths run it, with ``self_pairs``: a
    row that sits the round out gets α = 0 and is merged with itself (its
    own wire row), which must turn the inf and NaN put into it here into
    NaN (``1·x + 0·y``, as the reference computes it)."""
    import numpy as np

    from dpwa_tpu_torch.parallel import schedules

    n = N_PEERS
    rng = np.random.default_rng(1234)
    if kind == "b1":
        maps = {
            "ring_even": schedules._ring_even(n),
            "ring_odd": schedules._ring_odd(n),
            "sat_out": np.array([1, 0, 2, 3, 5, 4, 6, 7]),
        }
        llama_maps = {"full": np.array([1, 0, 3, 2]), "sat_out": np.array([1, 0, 2, 3])}
        r50_map = ("random_sat_out", random_sat_out_map(R50_PEERS))
    else:
        maps = {
            "pull_plus": schedules._ring_pull(n, 0),
            "pull_minus": schedules._ring_pull(n, 1),
        }
        llama_maps = {}
        r50_map = ("pull_plus", schedules._ring_pull(R50_PEERS, 0))
    wire_map = "sat_out" if kind == "b1" else "pull_plus"
    alphas = {
        "0.5": np.full(n, 0.5, np.float32),
        "random": rng.uniform(0.0, 1.0, n).astype(np.float32),
    }
    r50_alpha = rng.uniform(0.0, 1.0, R50_PEERS).astype(np.float32)
    bert_alpha = rng.uniform(0.0, 1.0, BERT_PEERS).astype(np.float32)
    row_alpha = {N_PEERS: alphas["random"], LLAMA_PEERS: alphas["random"][:LLAMA_PEERS],
                 MNIST_PEERS: alphas["random"][:MNIST_PEERS], R50_PEERS: r50_alpha,
                 BERT_PEERS: bert_alpha}
    mnist_map = np.array([1, 0])  # the 2-peer ring's only pairing
    # (rows, d, layout, map, perm, alpha name, alpha, wire, wire form?)
    cases = []
    for d in (MAIN_D, BIG_D):
        for map_name, perm in maps.items():
            if d == BIG_D and map_name != wire_map:
                continue  # bench's size, off every main path: one map there
            for a_name, a_np in alphas.items():
                for wire in ("f32", "bf16") if a_name == "random" else ("f32",):
                    cases.append((n, d, padded_rows, map_name, perm, a_name, a_np, wire, False))
            if d == MAIN_D or map_name == wire_map:
                for wire in WIRES:
                    cases.append((n, d, padded_rows, map_name, perm, "random",
                                  alphas["random"], wire, True))
    if llama_maps:
        lora_w = llama_lora_layout()[1]
        a_np = alphas["random"][:LLAMA_PEERS]
        for map_name, perm in llama_maps.items():
            for wire in ("f32", "bf16"):
                cases.append((LLAMA_PEERS, lora_w, llama_lora_rows, map_name, perm,
                              "random", a_np, wire, False))
    for wire, in_w in (("f32", False), ("bf16", False), ("int8", True)):
        cases.append((R50_PEERS, R50_D, padded_rows, *r50_map, "random", r50_alpha, wire, in_w))
    if kind == "b1":
        cases.append((BERT_PEERS, BERT_D, padded_rows, "hierarchical_intra", bert_map(),
                      "random", bert_alpha, "f32", False))
        cases.append((MNIST_PEERS, MNIST_D, padded_rows, "mnist_ring", mnist_map, "random",
                      row_alpha[MNIST_PEERS], "f32", False))
        cases.append((n, BN_D, padded_rows, "ring_even", maps["ring_even"], "random",
                      alphas["random"], "f32", False))
    max_err, n_checked = 0.0, 0
    gen = torch.Generator().manual_seed(7)
    base = {}
    for rows, d, layout, map_name, perm, a_name, a_np, wire, in_w in cases:
        if (rows, d) not in base:
            base.clear()  # one size's inputs on the host at a time
            base[rows, d] = torch.randn(rows, d, generator=gen)
        x_cpu = base[rows, d].clone()
        alpha = torch.from_numpy(a_np.copy())
        sat_out = sat_out_rows(perm) if kind == "b1" else []
        alpha[sat_out] = 0.0  # the exchange's α for a peer that sits out
        poison(x_cpu, sat_out)
        w_cpu = w = None
        if in_w:
            w_cpu = x_cpu + torch.randn(rows, d, generator=gen).mul_(0.25)
            poison(w_cpu, sat_out or [0])
            w = layout(torch, w_cpu, device)
        x = layout(torch, x_cpu, device)
        if kind == "b1":
            left, right = merge.involution_pairs(perm, self_pairs=True)
            left_t, right_t = torch.from_numpy(left), torch.from_numpy(right)
            merge.pair_merge_(
                x, left_t.to(device), right_t.to(device), alpha.to(device),
                wire=wire, self_pairs=True, w=w,
            )
            want = merge.torch_pair_merge_(
                x_cpu, left_t, right_t, alpha, wire=wire, self_pairs=True, w=w_cpu
            )
            got = x
        else:
            partner = torch.from_numpy(perm.astype(np.int32))
            got = merge.gather_merge(x, partner.to(device), alpha.to(device), wire=wire, w=w)
            want = merge.torch_pairwise_merge(x_cpu, partner, alpha, wire=wire, w=w_cpu)
        torch.cuda.synchronize()
        got = got.cpu()
        del x, w
        same, err = nan_equal(torch, got, want)
        if not same:
            raise AssertionError(
                f"{kind} differs from its plain version: shape=[{rows}, {d}] "
                f"map={map_name} alpha={a_name} wire={wire} wire_form={in_w} max_abs_err={err}"
            )
        if sat_out and not bool(got[sat_out][:, :3].isnan().all()):
            raise AssertionError(f"b1 [{rows}, {d}]: a sat-out inf did not become NaN")
        max_err = max(max_err, err)
        n_checked += 1
        del got, want, x_cpu, w_cpu
    del base
    torch.cuda.empty_cache()

    timings = {}
    map_name = next(iter(maps))
    # (key, rows, d, layout, perm, wire form?, iterations)
    timed = [("main", n, MAIN_D, padded_rows, maps[map_name], False, 30),
             ("main_wire", n, MAIN_D, padded_rows, maps[map_name], True, 30),
             ("big", n, BIG_D, padded_rows, maps[map_name], False, 10),
             ("big_wire", n, BIG_D, padded_rows, maps[map_name], True, 10),
             ("resnet50", R50_PEERS, R50_D, padded_rows, r50_map[1], False, 5),
             ("resnet50_wire", R50_PEERS, R50_D, padded_rows, r50_map[1], True, 5)]
    if llama_maps:
        timed.append(("llama", LLAMA_PEERS, lora_w, llama_lora_rows, llama_maps["full"], False, 30))
    if kind == "b1":
        timed.append(("bert", BERT_PEERS, BERT_D, padded_rows, bert_map(), False, 5))
        timed.append(("mnist", MNIST_PEERS, MNIST_D, padded_rows, mnist_map, False, 30))
        timed.append(("bn", n, BN_D, padded_rows, maps[map_name], False, 30))
    for key, rows, d, layout, perm, in_w, iters in timed:
        gen = torch.Generator(device=device).manual_seed(11)
        x = timed_rows(layout, torch, rows, d, device, gen)
        w = timed_rows(layout, torch, rows, d, device, gen) if in_w else None
        wire = "int8" if in_w else "f32"
        alpha = torch.from_numpy(row_alpha[rows]).to(device)
        partner64 = torch.from_numpy(perm.astype(np.int64)).to(device)
        y = (x if w is None else w)[partner64]  # pre-gathered rows for the library yardstick
        lib_out = torch.empty_like(y)
        streams = 3 if in_w else 2  # rows read and written per touched row
        if kind == "b1":
            left, right = (
                torch.from_numpy(v).to(device)
                for v in merge.involution_pairs(perm, self_pairs=True)
            )
            touched = int(torch.unique(torch.cat([left, right])).numel())
            kernel = lambda: merge.pair_merge_(x, left, right, alpha, wire=wire, self_pairs=True, w=w)
            plain = lambda: merge.torch_pair_merge_(x, left, right, alpha, wire=wire, self_pairs=True, w=w)
            n_bytes = streams * touched * d * 4
            flops = 3 * touched * d
        else:
            partner = partner64.to(torch.int32)
            out = merge.gather_merge(x, partner, alpha, wire=wire, w=w)
            kernel = lambda: merge.gather_merge(x, partner, alpha, wire=wire, out=out, w=w)
            plain = lambda: merge.torch_pairwise_merge(x, partner, alpha, wire=wire, w=w)
            n_bytes = streams * rows * d * 4  # x (and w) read once, out written once
            flops = 3 * rows * d
        library = lambda: torch.lerp(x, y, alpha[:, None], out=lib_out)
        ms = time_ms(torch, kernel, iters, flush)
        plain_ms = time_ms(torch, plain, max(3, iters // 3), flush)
        library_ms = time_ms(torch, library, iters, flush)
        b_ms, b_by = bound_ms(n_bytes, flops)
        timings[key] = {
            "shape": [rows, d], "row_stride": x.stride(0), "wire_form": in_w, "wire": wire,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "gb_per_s": n_bytes / (ms * 1e-3) / 1e9, "share_of_bound": b_ms / ms,
        }
        del x, w, y, lib_out
        if kind == "b2":
            del out
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"cases": n_checked, "max_abs_err": max_err, "timings": timings}


def timed_rows(layout, torch, rows: int, d: int, device, gen):
    """Normal values at ``[rows, d]`` on the card in ``layout``, drawn on the
    card (the timed inputs need not come from the host)."""
    if layout is padded_rows:
        buf = torch.randn(rows, -(-d // 32) * 32, device=device, generator=gen)
        return buf[:, :d]
    return layout(torch, torch.randn(rows, d, generator=torch.Generator().manual_seed(11)), device)


def flash_checks(torch, fa, device, flush, ptxas) -> dict:
    """B5: forward (o, lse) and backward (dq, dk, dv) against the plain
    versions on the same card tensors (TF32 off), then times at the main
    path's shape: the kernels, the plain versions, and SDPA's forward and
    backward on the same values (k and v pre-expanded to every head, in
    SDPA's [B, H, T, D] layout) as the library yardstick."""
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(5)
    cases, timings = {}, {}
    for name, b, t, h, kv, causal, q_scale in B5_CASES:
        q, do = (torch.randn(b, t, h, 128, device=device, generator=gen) for _ in range(2))
        q *= q_scale
        k, v = (torch.randn(b, t, kv, 128, device=device, generator=gen) for _ in range(2))
        o, lse = fa.flash_attn_fwd(q, k, v, causal=causal)
        grads = fa.flash_attn_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        want_o, want_lse = fa.torch_flash_attn_fwd(q, k, v, causal=causal)
        want = dict(zip(("dq", "dk", "dv"), fa.torch_flash_attn_bwd(
            q, k, v, want_o, want_lse, do, causal=causal)))
        got = {"o": o, "lse": lse, **dict(zip(("dq", "dk", "dv"), grads))}
        want.update(o=want_o, lse=want_lse)
        errs = {}
        for key in got:
            diff = (got[key] - want[key]).abs().max().item()
            scale = max(1.0, want[key].abs().max().item())
            errs[key] = {"max_abs_err": diff, "normwise": diff / scale}
            tol = B5_TOL["fwd" if key in ("o", "lse") else "bwd"]
            if not diff / scale <= tol:
                raise AssertionError(
                    f"b5 {name}: {key} normwise error {diff / scale} > {tol} "
                    f"(max_abs_err {diff})"
                )
        cases[name] = {"shape_q": [b, t, h, 128], "kv_heads": kv, "causal": causal,
                       "q_scale": q_scale, "errors": errs}
        if q_scale != 1.0:
            # Where the error against the plain version comes from: the
            # kernel's o and the plain float32 o, each against float64.
            o64 = fa.torch_flash_attn_fwd(q.double(), k.double(), v.double(), causal=causal)[0]
            cases[name]["o_normwise_vs_float64"] = {
                "kernel": normwise(o, o64)[1], "plain": normwise(want["o"], o64)[1],
            }
            del o64
        del want, want_o, want_lse, grads
        if name == "main":
            ke, ve = (x.repeat_interleave(h // kv, dim=2) for x in (k, v))
            qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, ke, ve))
            dos = do.transpose(1, 2).contiguous()

            def sdpa():
                with torch.no_grad():
                    return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
            sdpa_bwd = lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)
            plain_o, plain_lse = fa.torch_flash_attn_fwd(q, k, v, causal=causal)
            flops = 2 * b * h * t * t * 128  # causal: QKᵀ and PV over half the square
            qb, kvb = b * t * h * 128 * 4, b * t * kv * 128 * 4
            lse_b = b * h * t * 4
            for kind, kernel, plain, library, fl, nb in (
                ("fwd", lambda: fa.flash_attn_fwd(q, k, v, causal=causal),
                 lambda: fa.torch_flash_attn_fwd(q, k, v, causal=causal), sdpa,
                 flops, 2 * qb + 2 * kvb + lse_b),
                ("bwd", lambda: fa.flash_attn_bwd(q, k, v, o, lse, do, causal=causal),
                 lambda: fa.torch_flash_attn_bwd(q, k, v, plain_o, plain_lse, do, causal=causal),
                 sdpa_bwd, 2.5 * flops, 4 * qb + 4 * kvb + lse_b),
            ):
                ms = time_ms(torch, kernel, 10, flush)
                b_ms, b_by = bound_ms(nb, fl)
                timings[kind] = {
                    "ms": ms, "plain_ms": time_ms(torch, plain, 3, flush),
                    "library_ms": time_ms(torch, library, 10, flush),
                    "bound_ms": b_ms, "bound_by": b_by, "flops": fl, "bytes": nb,
                    "tflops_per_s": fl / (ms * 1e-3) / 1e12,
                }
                b3_ms, b3_by = bound_3xtf32_ms(nb, fl)  # both run on the tensor cores
                names = (FWD_KERNEL,) if kind == "fwd" else BWD_KERNELS[False]
                timings[kind].update(
                    bound_3xtf32_ms=b3_ms, bound_3xtf32_by=b3_by,
                    ptxas={n: ptxas.get(n) for n in names},
                )
            del qs, ks, vs, dos, out, ke, ve, plain_o, plain_lse
        del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()
    max_err = max(e["max_abs_err"] for c in cases.values() for e in c["errors"].values())
    return {"cases": cases, "max_abs_err": max_err, "tolerance": B5_TOL, "timings": timings}


def normwise(got, want) -> tuple[float, float]:
    """(max_abs_err, max|Δ| / max(1, max|want|))."""
    diff = (got - want).abs().max().item()
    return diff, diff / max(1.0, want.abs().max().item())


def library_attention(torch, q, k, v, dout):
    """The library yardstick of a causal ring over the whole sequence: one
    PyTorch call of causal attention over T that also returns the LSE
    (``_scaled_dot_product_efficient_attention``, float32), on k and v
    pre-expanded to every head in its [B, H, T, D] layout, and its backward
    through autograd.  Falls back to ``scaled_dot_product_attention`` where
    that call is missing.  Returns (name, forward, backward) callables."""
    import torch.nn.functional as F

    heads = q.shape[2]
    qs, ks, vs = (
        x.repeat_interleave(heads // x.shape[2], dim=2).transpose(1, 2).contiguous().requires_grad_()
        for x in (q, k, v)
    )
    dos = dout.transpose(1, 2).contiguous()
    try:
        op = torch.ops.aten._scaled_dot_product_efficient_attention
        out = op(qs, ks, vs, None, True, 0.0, True)[0]
        name = "aten._scaled_dot_product_efficient_attention (compute_log_sumexp, causal)"
        fwd = lambda: op(qs.detach(), ks.detach(), vs.detach(), None, True, 0.0, True)
    except (RuntimeError, AttributeError) as err:
        first = str(err).splitlines()[0] if str(err) else type(err).__name__
        print(f"chip_smoke: efficient attention unavailable ({first}); SDPA instead", file=sys.stderr)
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        name = "F.scaled_dot_product_attention (causal)"
        fwd = lambda: F.scaled_dot_product_attention(qs.detach(), ks.detach(), vs.detach(), is_causal=True)
    bwd = lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)
    return name, fwd, bwd, out.detach().transpose(1, 2)


def ring_checks(torch, fr, device, flush, kind: str, ptxas) -> dict:
    """B3 (kind "b3") or B4 ("b4") at the sequence-parallel path's shapes:
    every hop of the contiguous causal ring (skip, diag and full ranks), of
    the non-causal ring (all full) and of the zigzag ring (its three half
    stripe panels a hop), against the plain versions on the same card
    tensors (TF32 off), normwise at B5's tolerances; a skipped rank's rows
    exactly (0, -1e30) forward and untouched backward; B4 adds into
    accumulators that start non-zero.  Then the whole ring (every hop and
    the merges) through the kernels against the plain ring, and times: one
    layer's hops of the contiguous ring (the main path's launches), the
    plain hops, and the library's causal attention over the whole
    sequence."""
    b, h, kv, d = SP_PEERS, 32, 8, 128
    t_local = SP_T // SP_SIZE
    gen = torch.Generator(device=device).manual_seed(3)
    q, dout = (torch.randn(b, SP_T, h, d, device=device, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, SP_T, kv, d, device=device, generator=gen) for _ in range(2))
    tol = B5_TOL["fwd" if kind == "b3" else "bwd"]
    plans = {
        "contiguous": fr.hop_plan("contiguous", t_local, True),
        "non_causal": fr.hop_plan("contiguous", t_local, False),
        "zigzag": fr.hop_plan("zigzag", t_local, True),
    }
    residuals = {}
    if kind == "b4":  # the global lse and di each plan's backward is given
        for name, layout, causal in (("contiguous", "contiguous", True),
                                     ("non_causal", "contiguous", False),
                                     ("zigzag", "zigzag", True)):
            out32, lse = fr.ring_forward(q, k, v, SP_SIZE, layout, causal, impl="jnp")
            di = (out32 * dout).sum(-1).transpose(1, 2).contiguous()
            residuals[name] = (lse, di)
            del out32
    cases, max_err, worst = [], 0.0, 0.0
    seen = set()
    # B3 again with q scaled by 8 (large scores, a nearly one-hot softmax).
    stressed = {f"{name}_q8": plan for name, plan in plans.items()} if kind == "b3" else {}
    q8 = q * 8.0 if stressed else None
    for plan_name, (stripes, panels) in {**plans, **stressed}.items():
        qp = q8 if plan_name in stressed else q
        for hop in range(SP_SIZE):
            for stripe, k_off, rule in panels:
                q_off, rows = stripes[stripe]
                cs = fr.hop_cases(SP_SIZE, hop, rule)
                kw = dict(sp=SP_SIZE, hop=hop, cases=cs, rows=rows, q_off=q_off, k_off=k_off)
                if kind == "b3":
                    got = fr.ring_hop_fwd(qp, k, v, **kw)
                    want = fr.torch_ring_hop_fwd(qp, k, v, **kw)
                    torch.cuda.synchronize()
                    pairs = {"o": (got[0], want[0]), "lse": (got[1], want[1])}
                    for me, c in enumerate(cs):
                        if c == fr.SKIP:
                            r = slice(me * rows, (me + 1) * rows)
                            if got[0][:, r].any() or not bool((got[1][:, :, r] == fr.NEG_INF).all()):
                                raise AssertionError(f"b3 {plan_name} hop {hop}: a skipped rank wrote")
                            got[1][:, :, r] = want[1][:, :, r] = 0.0  # out of the normwise scale
                else:
                    lse, di = residuals[plan_name]
                    start = [torch.randn(x.shape, device=device, generator=gen) for x in (q, k, v)]
                    got = [x.clone() for x in start]
                    want = [x.clone() for x in start]
                    fr.ring_hop_bwd_(q, k, v, lse, dout, di, *got, **kw)
                    fr.torch_ring_hop_bwd_(q, k, v, lse, dout, di, *want, **kw)
                    torch.cuda.synchronize()
                    pairs = dict(zip(("dq", "dk", "dv"), zip(got, want)))
                    for me, c in enumerate(cs):
                        r = slice(me * t_local + q_off, me * t_local + q_off + rows)
                        if c == fr.SKIP and not torch.equal(got[0][:, r], start[0][:, r]):
                            raise AssertionError(f"b4 {plan_name} hop {hop}: a skipped rank's dq moved")
                    del start
                errs = {}
                for key, (g_, w_) in pairs.items():
                    diff, rel = normwise(g_, w_)
                    errs[key] = rel
                    max_err, worst = max(max_err, diff), max(worst, rel)
                    if not rel <= tol:
                        raise AssertionError(
                            f"{kind} {plan_name} hop {hop} rule {rule}: {key} normwise "
                            f"{rel} > {tol} (max_abs_err {diff})"
                        )
                seen.update(cs)
                cases.append([plan_name, hop, rule, "".join("sdf"[c] for c in cs), max(errs.values())])
                del got, want, pairs
    if seen != {fr.SKIP, fr.DIAG, fr.FULL}:
        raise AssertionError(f"{kind}: cases seen {seen}")
    residuals.clear()
    del q8
    torch.cuda.empty_cache()

    # The whole ring through the kernels against the plain ring.
    ring = {}
    for layout in ("contiguous", "zigzag"):
        out_k, lse_k = fr.ring_forward(q, k, v, SP_SIZE, layout, True, impl="flash")
        out_p, lse_p = fr.ring_forward(q, k, v, SP_SIZE, layout, True, impl="jnp")
        if kind == "b3":
            pairs = {"out": (out_k, out_p), "lse": (lse_k, lse_p)}
        else:
            grads_k = fr.ring_backward(q, k, v, out_k, lse_k, dout, SP_SIZE, layout, True, "flash")
            grads_p = fr.ring_backward(q, k, v, out_p, lse_p, dout, SP_SIZE, layout, True, "jnp")
            pairs = dict(zip(("dq", "dk", "dv"), zip(grads_k, grads_p)))
        torch.cuda.synchronize()
        ring[layout] = {}
        for key, (g_, w_) in pairs.items():
            diff, rel = normwise(g_, w_)
            ring[layout][key] = rel
            max_err, worst = max(max_err, diff), max(worst, rel)
            if not rel <= tol:
                raise AssertionError(f"{kind} whole {layout} ring: {key} normwise {rel} > {tol}")
        del out_k, lse_k, out_p, lse_p, pairs
        torch.cuda.empty_cache()

    # Times: one layer's hops of the main path's contiguous causal ring.
    stripes, panels = plans["contiguous"]
    calls = [fr.hop_cases(SP_SIZE, hop, "causal") for hop in range(SP_SIZE)]
    lib_name, lib_fwd, lib_bwd, lib_out = library_attention(torch, q, k, v, dout)
    out32, lse = fr.ring_forward(q, k, v, SP_SIZE, "contiguous", True, impl="flash")
    lib_err = normwise(out32, lib_out)[1]
    flops = 2 * b * h * SP_T * SP_T * d  # causal attention over T: QKᵀ and PV, half the square
    qb, kvb, lb = b * SP_T * h * d * 4, b * SP_T * kv * d * 4, b * h * SP_T * 4
    if kind == "b3":
        kernel = lambda: [fr.ring_hop_fwd(q, k, v, sp=SP_SIZE, hop=i, cases=c) for i, c in enumerate(calls)]
        plain = lambda: [fr.torch_ring_hop_fwd(q, k, v, sp=SP_SIZE, hop=i, cases=c)
                         for i, c in enumerate(calls)]
        library = lib_fwd
        n_bytes = qb + 2 * kvb + SP_SIZE * (qb + lb)  # every hop writes its o and lse
        work = flops
    else:
        di = (out32 * dout).sum(-1).transpose(1, 2).contiguous()
        acc = [torch.zeros_like(x) for x in (q, k, v)]
        kernel = lambda: [fr.ring_hop_bwd_(q, k, v, lse, dout, di, *acc, sp=SP_SIZE, hop=i, cases=c)
                          for i, c in enumerate(calls)]
        plain = lambda: [fr.torch_ring_hop_bwd_(q, k, v, lse, dout, di, *acc, sp=SP_SIZE, hop=i,
                                                cases=c) for i, c in enumerate(calls)]
        library = lib_bwd
        # q, k, v, dout, lse, di read; dq, dk, dv written (the sums read them too)
        n_bytes = 2 * qb + 2 * kvb + 2 * lb + 2 * SP_SIZE * (qb + 2 * kvb)
        work = 2.5 * flops
    ms = time_ms(torch, kernel, 5, flush)
    b_ms, b_by = bound_ms(n_bytes, work)
    timings = {
        "shape_q": [b, SP_T, h, d], "kv_heads": kv, "sp": SP_SIZE, "launches_timed": SP_SIZE,
        "ms": ms, "plain_ms": time_ms(torch, plain, 2, flush),
        "library_ms": time_ms(torch, library, 5, flush), "library": lib_name,
        "library_out_normwise_vs_ring": lib_err,
        "bound_ms": b_ms, "bound_by": b_by, "flops": work, "bytes": n_bytes,
        "tflops_per_s": work / (ms * 1e-3) / 1e12,
    }
    b3_ms, b3_by = bound_3xtf32_ms(n_bytes, work)  # both run on the tensor cores
    timings.update(bound_3xtf32_ms=b3_ms, bound_3xtf32_by=b3_by,
                   ptxas={n: ptxas.get(n) for n in ((FWD_KERNEL,) if kind == "b3" else BWD_KERNELS[True])})
    # The zigzag ring's panels: the same work in 3·sp launches.
    zz_stripes, zz_panels = plans["zigzag"]
    zz_calls = [(hop, fr.hop_cases(SP_SIZE, hop, rule), zz_stripes[s_][0], zz_stripes[s_][1], k_off)
                for hop in range(SP_SIZE) for s_, k_off, rule in zz_panels]
    if kind == "b3":
        zz = lambda: [fr.ring_hop_fwd(q, k, v, sp=SP_SIZE, hop=i, cases=c, rows=r, q_off=qo, k_off=ko)
                      for i, c, qo, r, ko in zz_calls]
    else:
        _, lse_z = fr.ring_forward(q, k, v, SP_SIZE, "zigzag", True, impl="flash")
        zz = lambda: [fr.ring_hop_bwd_(q, k, v, lse_z, dout, di, *acc, sp=SP_SIZE, hop=i, cases=c,
                                       rows=r, q_off=qo, k_off=ko) for i, c, qo, r, ko in zz_calls]
    timings["zigzag_ms"] = time_ms(torch, zz, 5, flush)
    timings["zigzag_launches_timed"] = len(zz_calls)
    return {"cases": cases, "cases_are": "[plan, hop, rule, rank cases (skip/diag/full), max normwise]",
            "n_cases": len(cases), "whole_ring_normwise": ring,
            "max_abs_err": max_err, "max_normwise": worst, "tolerance": tol, "timings": timings}


def run_differences(torch, a: dict, b: dict) -> list[str]:
    """What differs, bit for bit, between two MNIST example runs' final
    states and data streams (an empty list when nothing does)."""
    sa, sb = a["state"], b["state"]
    pairs = {
        "params": (sa.params.flat, sb.params.flat),
        "adam_mu": (sa.opt_state.mu, sb.opt_state.mu),
        "adam_nu": (sa.opt_state.nu, sb.opt_state.nu),
        "clock": (sa.clock, sb.clock), "loss": (sa.loss, sb.loss),
    }
    diff = [k for k, (x, y) in pairs.items() if not torch.equal(x, y)]
    if (sa.step, sa.opt_state.count) != (sb.step, sb.opt_state.count):
        diff.append("step")
    if a["stream"].state_dict() != b["stream"].state_dict():
        diff.append("stream")
    return diff


def tcp_merge_checks(torch, merge, device, flush) -> dict:
    """B2 as the TCP transport's merge runs it: one row, x the replica and
    w the landed frame, at the MNIST TCP path's ``[1, 66410]`` (SmallNet,
    ``train_tcp``) and at ResNet-50's ``[1, 25557032]`` (``tcp_exchange``);
    a float32 frame (the int8 wire's form, ``fma(1-α, x, α·y)``) and a
    bf16 frame read as it landed (widened in the kernel).  Bit-equality
    against the plain version on a CPU copy, inf and NaN in both rows, then
    times: bytes x and out 4 each and w 4 or 2 (at ResNet-50 306.7 or
    255.6 MB)."""
    from dpwa_tpu_torch.device.engine import BF16_FORM, F32_FORM

    gen = torch.Generator().manual_seed(21)
    zero_cpu = torch.zeros(1, dtype=torch.int32)
    alpha_cpu = torch.tensor([0.3])
    zero, alpha = zero_cpu.to(device), alpha_cpu.to(device)
    out = {}
    for shape_name, d, iters in (("mnist", MNIST_D, 30), ("resnet50", R50_D, 10)):
        out[shape_name] = {}
        for wire, dtype, form in (("f32", torch.float32, F32_FORM),
                                  ("bf16", torch.bfloat16, BF16_FORM)):
            x_cpu = torch.randn(1, d, generator=gen)
            w_cpu = torch.randn(1, d, generator=gen)
            poison(x_cpu, [0])
            w_cpu[0, -5:] = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.0, 3.0e38])
            w_cpu = w_cpu.to(dtype)
            x, w = x_cpu.to(device), w_cpu.to(device)
            got = merge.gather_merge(x, zero, alpha, wire=form, w=w)
            torch.cuda.synchronize()
            same, err = nan_equal(torch, got.cpu(), merge.torch_pairwise_merge(
                x_cpu, zero_cpu, alpha_cpu, wire=form, w=w_cpu))
            if not same:
                raise AssertionError(f"b2 [1, {d}] with a {wire} frame differs from its plain "
                                     f"version: max_abs_err={err}")
            res = torch.empty_like(got)
            kernel = lambda: merge.gather_merge(x, zero, alpha, wire=form, out=res, w=w)
            plain = lambda: merge.torch_pairwise_merge(x, zero, alpha, wire=form, w=w)
            w32 = w.to(torch.float32)  # the library call takes the frame pre-widened
            lib_out = torch.empty_like(x)
            library = lambda: torch.lerp(x, w32, alpha[:, None], out=lib_out)
            n_bytes = d * (4 + w.element_size() + 4)
            b_ms, b_by = bound_ms(n_bytes, 3 * d)
            ms = time_ms(torch, kernel, iters, flush)
            out[shape_name][wire] = {
                "shape": [1, d], "form": form, "w_dtype": str(dtype).split(".")[-1],
                "max_abs_err": err, "ms": ms, "plain_ms": time_ms(torch, plain, 3, flush),
                "library_ms": time_ms(torch, library, iters, flush), "bound_ms": b_ms,
                "bound_by": b_by, "bytes": n_bytes, "share_of_bound": b_ms / ms,
            }
            del x, w, w32, got, res, lib_out
    torch.cuda.empty_cache()
    return out


def free_ports(n: int) -> list:
    """``n`` ports the OS calls free now (bound to port 0, then released)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def tcp_config(workdir: str, n: int = 2, extra: str = "", protocol: str = "") -> str:
    """A copy of ``examples/mnist/nodes.yaml`` under ``workdir`` with free
    ports, its two nodes followed by ``n - 2`` more, ``protocol`` lines
    added to its ``protocol:`` block and ``extra`` (YAML blocks) appended;
    its path."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(HERE, "examples/mnist/nodes.yaml")) as f:
        text = f.read()
    last = "  - {name: node1, host: 127.0.0.1, port: 45001}\n"
    if last not in text:
        raise AssertionError(f"examples/mnist/nodes.yaml has no {last!r}")
    text = text.replace(last, last + "".join(
        f"  - {{name: node{i}, host: 127.0.0.1, port: {45000 + i}}}\n" for i in range(2, n)))
    for i in range(n):  # placeholders first: a free port may be 4500x itself
        text = text.replace(f"port: {45000 + i}}}", f"port: PORT{i}}}")
    for i, new in enumerate(free_ports(n)):
        text = text.replace(f"port: PORT{i}}}", f"port: {new}}}")
    if "  seed: 0\n" not in text:
        raise AssertionError("examples/mnist/nodes.yaml has no '  seed: 0' protocol line")
    text = text.replace("  seed: 0\n", "  seed: 0\n" + protocol, 1)
    config = os.path.join(workdir, "nodes.yaml")
    with open(config, "w") as f:
        f.write(text + extra)
    return config


def mnist_node(config: str, name: str, steps: int, extra=(), env=None, stdout=subprocess.PIPE,
               stderr=subprocess.PIPE):
    """One OS process of ``dpwa_tpu_torch.examples.mnist --transport tcp``."""
    return subprocess.Popen(
        [sys.executable, "-m", "dpwa_tpu_torch.examples.mnist", "--transport", "tcp",
         "--name", name, "--config", config, "--steps", str(steps), "--batch-size", "32",
         *extra],
        cwd=HERE, stdout=stdout, stderr=stderr, text=True, env=env,
    )


def node_result(phase: str, name: str, rc: int, stdout: str, stderr: str, kind: str,
                steps: int) -> dict:
    """A TCP node's summary line, checked: it ran on ``kind`` to ``steps``,
    reached test accuracy 0.9, and launched B2 once a merged round."""
    lines = stdout.strip().splitlines()
    if rc != 0 or not lines:
        print(stdout[-3000:], stderr[-3000:], file=sys.stderr)
        raise AssertionError(f"{phase}: {name} exited {rc}")
    res = json.loads(lines[-1])
    if res["device"] != kind or res["steps"] != steps:
        raise AssertionError(f"{phase}: {name} ran on {res['device']} for {res['steps']} steps")
    if not res["accuracy"] >= 0.9:
        raise AssertionError(f"{phase}: {name} test accuracy {res['accuracy']} < 0.9")
    if res.get("async") is not None:
        # Barrier-free rounds: a merge is a B2 launch or a frame of a fold.
        a = res["async"]
        if (a["merges"] < 1 or res["b2_launches"] + a["fold_frames"] != a["merges"]
                or res["fold_launches"] != a["fold_dispatches"]):
            raise AssertionError(
                f"{phase}: {name} merged {a['merges']} frames ({a['fold_frames']} in "
                f"{a['fold_dispatches']} folds) with {res['b2_launches']} B2 and "
                f"{res['fold_launches']} fold launches")
    elif res["merged_rounds"] < 1 or res["b2_launches"] != res["merged_rounds"]:
        raise AssertionError(
            f"{phase}: {name} merged {res['merged_rounds']} rounds with "
            f"{res['b2_launches']} B2 launches")
    return res


def run_pair(phase: str, kind: str, steps: int, extras=((), ()), blocks: str = "",
             protocol: str = "") -> list:
    """Two TCP nodes of the MNIST example (``protocol`` lines and ``blocks``
    added to their config) run to their end; their checked summaries."""
    workdir = os.path.join(HERE, "build", phase)
    config = tcp_config(workdir, extra=blocks, protocol=protocol)
    procs = []
    try:
        for i, extra in enumerate(extras):
            procs.append(mnist_node(config, f"node{i}", steps, extra))
        outs = [p.communicate(timeout=TCP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    nodes = [node_result(phase, f"node{i}", p.returncode, *out, kind, steps)
             for i, (p, out) in enumerate(zip(procs, outs))]
    shutil.rmtree(workdir, ignore_errors=True)
    return nodes


def train_tcp(kind: str) -> dict:
    """Two OS processes of ``dpwa_tpu_torch.examples.mnist --transport tcp``,
    node0 and node1 of a copy of ``examples/mnist/nodes.yaml`` on two free
    ports, each with its replica on the card, free-running 300 steps as the
    reference's ``run_tcp.sh`` runs them, at the default planes (recovery's
    guard, ring and STATE serving, and health on); each process's summary
    line."""
    return {"nodes": run_pair("train_tcp", kind, MNIST_STEPS)}


def train_tcp_planes(kind: str) -> dict:
    """``train_tcp`` at the defaults and with the membership, trust and
    flowctl planes switched off in its config, the variants in turns in this one
    call (the order of ``PLANE_VARIANTS``, then reversed, ``PLANES_REPS``
    times): each run's mean steps/s over its two processes, and each
    variant's median and its seconds a step."""
    runs = {name: [] for name in PLANE_VARIANTS}
    order = (list(PLANE_VARIANTS) + list(PLANE_VARIANTS)[::-1]) * PLANES_REPS
    for name in order:
        nodes = run_pair("train_tcp_planes", kind, MNIST_STEPS, blocks=PLANE_VARIANTS[name])
        runs[name].append(sum(n["steps_per_sec"] for n in nodes) / len(nodes))
    import statistics

    medians = {name: statistics.median(v) for name, v in runs.items()}
    return {"order": order, "steps_per_sec": runs, "median_steps_per_sec": medians,
            "median_ms_per_step": {name: 1e3 / m for name, m in medians.items()}}


def slowpeer_tcp(kind: str) -> dict:
    """Four OS processes of the MNIST example (``examples/mnist/nodes.yaml``
    widened to 4 nodes, at the default planes) with ``SLOW_CHAOS``: node2
    serves its frames at 2048 B/s for its publish clocks ``SLOW_WINDOW``.
    Passes only if every node reaches accuracy 0.9 and node2's ring
    partners (node1 and node3) soft-degrade node2 and never quarantine it
    (nor does node0), classify their fetches of it only as ``slow``,
    ``busy`` or ``success`` (a hedge's won fetch is a success), shed at
    least one degraded round to a fallback that succeeds, and take no round
    longer than the flowctl budget: the primary's deadline and a hedge
    leg's, each at most ``max(protocol.timeout_ms, flowctl.max_ms)``, and a
    second for the rest of the step."""
    workdir = os.path.join(HERE, "build", "slowpeer_tcp")
    shutil.rmtree(workdir, ignore_errors=True)
    config = tcp_config(workdir, SLOW_NODES, extra=SLOW_CHAOS)
    logs = [os.path.join(workdir, f"node{i}_rounds.jsonl") for i in range(SLOW_NODES)]
    procs = []
    try:
        procs = [mnist_node(config, f"node{i}", SLOW_STEPS,
                            ("--barrier", os.path.join(workdir, "barrier"),
                             "--round-log", logs[i], "--log-every", "1000"))
                 for i in range(SLOW_NODES)]
        outs = [p.communicate(timeout=TCP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    nodes = [node_result("slowpeer_tcp", f"node{i}", p.returncode, *out, kind, SLOW_STEPS)
             for i, (p, out) in enumerate(zip(procs, outs))]
    from dpwa_tpu_torch.config import load_config

    cfg = load_config(config)
    budget_ms = 2 * max(cfg.protocol.timeout_ms, cfg.flowctl.max_ms) + 1000
    rounds = []
    for path in logs:
        with open(path) as f:
            rounds.append([json.loads(line) for line in f])
    shutil.rmtree(workdir, ignore_errors=True)
    partners = [(SLOW_VICTIM - 1) % SLOW_NODES, (SLOW_VICTIM + 1) % SLOW_NODES]
    shed_ok, victim_outcomes = [], {}
    for i, res in enumerate(nodes):
        states = [e["state"] for e in res["health_events"] if e["peer"] == SLOW_VICTIM]
        if "quarantined" in states:
            raise AssertionError(f"slowpeer_tcp: node{i} quarantined node{SLOW_VICTIM}: "
                                 f"{res['health_events']}")
        worst = max(r["round_ms"] for r in rounds[i][1:])
        if worst > budget_ms:
            raise AssertionError(f"slowpeer_tcp: node{i} took {worst} ms for a round "
                                 f"(budget {budget_ms} ms)")
        if i not in partners:
            continue
        if "degraded" not in states:
            raise AssertionError(f"slowpeer_tcp: node{i} never degraded node{SLOW_VICTIM}: "
                                 f"{res['health_events']}")
        got = [r["outcome"] for r in rounds[i] if r["partner"] == SLOW_VICTIM and r["outcome"]]
        victim_outcomes[f"node{i}"] = {o: got.count(o) for o in sorted(set(got))}
        if set(got) - {"slow", "busy", "success"}:
            odd = [r for r in rounds[i] if r["partner"] == SLOW_VICTIM
                   and r["outcome"] not in (None, "slow", "busy", "success")]
            raise AssertionError(f"slowpeer_tcp: node{i} classified node{SLOW_VICTIM}'s fetches "
                                 f"as {victim_outcomes[f'node{i}']}: {odd}")
        shed_ok += [r for r in rounds[i] if r["sched_partner"] == SLOW_VICTIM and r["remapped"]
                    and r["sched_state"] == "degraded" and r["outcome"] == "success"]
    if not shed_ok:
        raise AssertionError(f"slowpeer_tcp: no degraded round of node{SLOW_VICTIM} was shed "
                             f"to a fallback that succeeded")
    per_node = lambda key: {f"node{i}": n[key] for i, n in enumerate(nodes)}
    return {
        "nodes_steps": SLOW_STEPS, "victim": SLOW_VICTIM, "trickle_window": list(SLOW_WINDOW),
        "trickle_bytes_per_s": 2048.0, "round_budget_ms": budget_ms,
        "steps_per_sec": per_node("steps_per_sec"), "accuracy": per_node("accuracy"),
        "outcomes": per_node("outcomes"), "victim_fetch_outcomes": victim_outcomes,
        "hedged_rounds": per_node("hedged_rounds"),
        "hedges": {f"node{i}": n["flowctl"]["hedges"] for i, n in enumerate(nodes)},
        "hedge_wins": {f"node{i}": n["flowctl"]["hedge_wins"] for i, n in enumerate(nodes)},
        "shed_rounds": per_node("shed_rounds"), "shed_rounds_succeeded": len(shed_ok),
        "remapped_rounds": per_node("remapped_rounds"),
        "deadline_ms": {f"node{i}": n["flowctl"]["deadline_ms"] for i, n in enumerate(nodes)},
        "busy": {f"node{i}": n["flowctl"]["busy"] for i, n in enumerate(nodes)},
        "slow": {f"node{i}": n["flowctl"]["slow"] for i, n in enumerate(nodes)},
        "admission": {f"node{i}": n["flowctl"]["admission"] for i, n in enumerate(nodes)},
        "health_events": per_node("health_events"),
        "b2_launches": per_node("b2_launches"), "merged_rounds": per_node("merged_rounds"),
        "round_ms": per_node("round_ms"),
    }


def rollback_tcp(kind: str) -> dict:
    """``train_tcp`` with node1's replica and loss turned NaN after step
    ``ROLLBACK_AT``'s update: node1 must roll back to its ring on the card
    (once, restored), and node0 must record no ``poisoned`` fetch, since
    the frame carries the snapshot's loss; both finish at accuracy 0.9."""
    nodes = run_pair("rollback_tcp", kind, MNIST_STEPS,
                     extras=((), ("--diverge-at", str(ROLLBACK_AT))))
    sick, partner = nodes[1], nodes[0]
    want = {"step": ROLLBACK_AT, "reason": "nonfinite_params", "restored": True,
            "snapshot_step": ROLLBACK_AT - 1}
    if sick["rollbacks"] != 1 or sick["last_rollback"] != want:
        raise AssertionError(f"rollback_tcp: node1 rolled back {sick['rollbacks']} times, "
                             f"last {sick['last_rollback']}, expected {want}")
    if "poisoned" in partner["outcomes"] or "poisoned" in sick["outcomes"]:
        raise AssertionError(f"rollback_tcp: a poisoned fetch: {[n['outcomes'] for n in nodes]}")
    return {"nodes": nodes, "rollback": sick["last_rollback"]}


def recover_tcp(kind: str, extra=()) -> dict:
    """Kill and restart a TCP node.  node0 and node1 run ``RECOVER_STEPS``
    steps at the default planes; once node1 reports ``RECOVER_KILL_MERGED``
    merged rounds it is killed with SIGKILL from here.  node0 must
    quarantine it and remap (with two nodes a remap is a self-pair: solo
    rounds), probing it as its backoff runs out.  node1 restarts at once
    with ``DPWA_BOOTSTRAP=1``: it must land on node0's published step and
    clock and on a replica bit-equal to what node0 served (node0's
    ``--trace-state`` log of each round's step, clock and CRC-32), be
    readmitted, and both must merge again and end at accuracy 0.9."""
    workdir = os.path.join(HERE, "build", "recover_tcp")
    config = tcp_config(workdir)
    trace = os.path.join(workdir, "node0_state.jsonl")
    logs = {n: open(os.path.join(workdir, f"{n}.log"), "w+")
            for n in ("node0.out", "node0.err", "node1a.err", "node1b.out", "node1b.err")}
    procs = []
    try:
        node0 = mnist_node(config, "node0", RECOVER_STEPS,
                           (*extra, "--trace-state", trace, "--log-every", "1000"),
                           stdout=logs["node0.out"], stderr=logs["node0.err"])
        procs.append(node0)
        node1 = mnist_node(config, "node1", RECOVER_STEPS, (*extra, "--log-every", "10"),
                           stderr=logs["node1a.err"])
        procs.append(node1)
        merged_at_kill = None
        deadline = time.monotonic() + TCP_TIMEOUT_S
        for line in node1.stdout:
            if line.startswith("{") and json.loads(line).get("merged", 0) >= RECOVER_KILL_MERGED:
                node1.kill()  # SIGKILL: no close, no goodbye
                t_kill = time.monotonic()
                merged_at_kill = json.loads(line)
                break
            if time.monotonic() > deadline:
                break
        node1.wait(timeout=60)
        if merged_at_kill is None:
            raise AssertionError(f"recover_tcp: node1 never reported {RECOVER_KILL_MERGED} "
                                 f"merged rounds (exit {node1.returncode})")
        env = dict(os.environ, DPWA_BOOTSTRAP="1")
        restarted = mnist_node(config, "node1", RECOVER_STEPS, (*extra, "--log-every", "1000"),
                               env=env, stdout=logs["node1b.out"], stderr=logs["node1b.err"])
        procs.append(restarted)
        rcs = [p.wait(timeout=TCP_TIMEOUT_S) for p in (node0, restarted)]
        seconds_after_kill = time.monotonic() - t_kill
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = {}
    for n, f in logs.items():
        f.seek(0)
        texts[n] = f.read()
        f.close()
    res0 = node_result("recover_tcp", "node0", rcs[0], texts["node0.out"], texts["node0.err"],
                       kind, RECOVER_STEPS)
    res1 = node_result("recover_tcp", "node1 (restarted)", rcs[1], texts["node1b.out"],
                       texts["node1b.err"], kind, RECOVER_STEPS)
    boot = next((json.loads(line)["bootstrap"] for line in texts["node1b.out"].splitlines()
                 if line.startswith('{"node"') and '"bootstrap"' in line), None)
    if boot is None or res1["bootstrap"] is None:
        print(texts["node1b.out"][-3000:], texts["node1b.err"][-3000:], file=sys.stderr)
        raise AssertionError("recover_tcp: the restarted node1 did not bootstrap")
    with open(trace) as f:
        served = {e["step"]: e for e in map(json.loads, f)}
    at = served.get(boot["step"])
    if at is None or (at["clock"], at["crc32"]) != (boot["clock"], boot["crc32"]):
        raise AssertionError(f"recover_tcp: node1 landed on step {boot['step']}, clock "
                             f"{boot['clock']}, crc32 {boot['crc32']}; node0 published {at}")
    if res1["start_step"] != boot["step"] or boot["donor"] != 0:
        raise AssertionError(f"recover_tcp: node1 restarted at {res1['start_step']} after "
                             f"landing on {boot['step']} from donor {boot['donor']}")
    events = res0["health_events"]
    quarantined = [e["step"] for e in events if e["state"] == "quarantined"]
    if not quarantined or res0["remapped_rounds"] < 1:
        raise AssertionError(f"recover_tcp: node0 never quarantined node1: {events}")
    # The first readmission after the kill (at the very end node0 may see
    # node1 gone again: the one that finishes first leaves).
    readmitted = [e["step"] for e in events if e["state"] == "healthy" and e["step"] > quarantined[0]]
    if not readmitted:
        raise AssertionError(f"recover_tcp: node0 did not readmit node1: {events}")
    successes = res0["outcomes"].get("success", 0)
    if successes < merged_at_kill["merged"] + RECOVER_MIN_MERGED or (
            res1["merged_rounds"] < RECOVER_MIN_MERGED):
        raise AssertionError(
            f"recover_tcp: too few merges after the restart: node0 {successes} successes "
            f"({merged_at_kill['merged']} before the kill), node1 {res1['merged_rounds']}")
    shutil.rmtree(workdir, ignore_errors=True)
    chunk = 1 << 20  # recovery.state_chunk_bytes at its default
    return {
        "steps": RECOVER_STEPS, "killed_after_merged": merged_at_kill["merged"],
        "killed_at_step": merged_at_kill["step"],
        "quarantine_round": quarantined[0], "readmission_round": readmitted[0],
        "rounds_remapped": res0["remapped_rounds"], "probes_sent": res0["probes"],
        "health_events": events,
        "bootstrap": {"step": boot["step"], "clock": boot["clock"], "crc32": boot["crc32"],
                      "bytes": boot["nbytes"], "chunks": -(-boot["nbytes"] // chunk),
                      "attempts": boot["attempts"], "ms": boot["latency_s"] * 1e3},
        "seconds_kill_to_end": seconds_after_kill,
        "steps_per_sec": {"node0": res0["steps_per_sec"], "node1_restarted": res1["steps_per_sec"]},
        "merged_rounds": {"node0": res0["merged_rounds"], "node1_before_kill": merged_at_kill["merged"],
                          "node1_restarted": res1["merged_rounds"]},
        "b2_launches": {"node0": res0["b2_launches"], "node1_restarted": res1["b2_launches"]},
        "accuracy": {"node0": res0["accuracy"], "node1_restarted": res1["accuracy"]},
        "outcomes": {"node0": res0["outcomes"], "node1_restarted": res1["outcomes"]},
        "relay_probes": {"node0": res0["relay_probes"], "node1_restarted": res1["relay_probes"]},
        "events": {"node0": res0["events"], "node1_restarted": res1["events"]},
    }


def byzantine_node(torch, config: str, device, stop, out: dict) -> None:
    """node3 of ``byzantine_tcp``, run on a thread of this process until
    ``stop`` is set: a port ``TcpTransport`` (trust off: an attacker does
    not screen) that starts from SmallNet's init for ``key(3)``, then each
    round publishes the replica it last fetched with its own clock
    advancing, and from the flip on that replica's sign-flip, and fetches
    from its ring partner.  ``out`` gets the clock of its first flipped
    frame and its digest bytes."""
    from dpwa_tpu_torch.adapters.tcp_adapter import DpwaTcpAdapter
    from dpwa_tpu_torch.config import load_config
    from dpwa_tpu_torch.data import load_mnist_or_digits
    from dpwa_tpu_torch.models import mnist
    from dpwa_tpu_torch.utils import prng

    cfg = load_config(config)
    cfg = dataclasses.replace(cfg, trust=dataclasses.replace(cfg.trust, enabled=False))
    model = mnist.build_model(load_mnist_or_digits()[0].shape[1:]).to(device)
    adapter = DpwaTcpAdapter(mnist.init(model, prng.key(3), device), "node3", cfg, device=device)
    t = adapter.transport
    vec, loss, seen = adapter.vector(), 0.5, {}
    clock, step, flip_clock = 0.0, 0, None
    try:
        while not stop.is_set():
            clock += 1.0
            if flip_clock is None and len(seen) == 2 and min(seen.values()) >= BYZ_FLIP_AFTER:
                flip_clock = clock
            t.publish(vec if flip_clock is None else -vec, clock, loss)
            partner = t.schedule.partner(step, t.me)
            got = t.fetch(partner, step=step, device=device) if partner != t.me else None
            if got is not None:
                vec, seen[partner], loss = got[0].to(torch.float32), got[1], got[2]
            step += 1
            stop.wait(BYZ_ROUND_S)
    finally:
        out.update(flip_clock=flip_clock, clock=clock, rounds=step,
                   digest_bytes=t.last_digest_nbytes, rx_server=type(t.server).__name__,
                   reactor=t.health_snapshot().get("reactor"))
        adapter.close()


def byzantine_tcp(torch, kind: str, device, phase: str = "byzantine_tcp", protocol: str = "",
                  blocks: str = "") -> dict:
    """Three OS processes of the MNIST example (node0-2 of
    ``examples/mnist/nodes.yaml`` widened to 4 nodes, at the default planes,
    ``protocol`` lines and ``blocks`` added) and a byzantine node3
    (:func:`byzantine_node`).  Passes only if every honest node reaches
    accuracy 0.9 and merges no frame of node3 from its flip on (each node's
    newest merged clock of node3 is below the flip's), and node3's ring
    partners (node0 and node2) record ``untrusted`` fetches and quarantine
    it."""
    import threading

    workdir = os.path.join(HERE, "build", phase)
    config = tcp_config(workdir, BYZ_NODES, extra=blocks, protocol=protocol)
    stop, byz = threading.Event(), {}
    thread = threading.Thread(target=byzantine_node, args=(torch, config, device, stop, byz))
    thread.start()
    procs = []
    try:
        procs = [mnist_node(config, f"node{i}", BYZ_STEPS) for i in range(BYZ_NODES - 1)]
        outs = [p.communicate(timeout=TCP_TIMEOUT_S) for p in procs]
    finally:
        stop.set()
        thread.join(timeout=60)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    nodes = [node_result(phase, f"node{i}", p.returncode, *out, kind, BYZ_STEPS)
             for i, (p, out) in enumerate(zip(procs, outs))]
    shutil.rmtree(workdir, ignore_errors=True)
    flip = byz.get("flip_clock")
    if flip is None:
        raise AssertionError(f"{phase}: node3 never flipped ({byz})")
    quarantined = {}
    for i, res in enumerate(nodes):
        merged = res["merged_from"].get("3")
        if merged is not None and merged[1] >= flip:
            raise AssertionError(f"{phase}: node{i} merged node3's clock {merged[1]} "
                                 f"at or after its flip at clock {flip}")
        steps = [e["step"] for e in res["health_events"]
                 if e["peer"] == 3 and e["state"] == "quarantined"]
        quarantined[f"node{i}"] = steps[0] if steps else None
    for i in (0, 2):
        if not nodes[i]["outcomes"].get("untrusted") or quarantined[f"node{i}"] is None:
            raise AssertionError(f"{phase}: node{i} did not reject and quarantine node3: "
                                 f"{nodes[i]['outcomes']}, {nodes[i]['health_events']}")
    return {
        "flip_clock": flip, "byzantine_rounds": byz["rounds"],
        "digest_bytes_per_frame": {"node3": byz["digest_bytes"],
                                   **{f"node{i}": n["digest_bytes"] for i, n in enumerate(nodes)}},
        "verdicts": {f"node{i}": n["verdicts"] for i, n in enumerate(nodes)},
        "outcomes": {f"node{i}": n["outcomes"] for i, n in enumerate(nodes)},
        "merged_from_node3": {f"node{i}": n["merged_from"].get("3") for i, n in enumerate(nodes)},
        "quarantine_step": quarantined,
        "events": {f"node{i}": n["events"] for i, n in enumerate(nodes)},
        "accuracy": {f"node{i}": n["accuracy"] for i, n in enumerate(nodes)},
        "steps_per_sec": {f"node{i}": n["steps_per_sec"] for i, n in enumerate(nodes)},
        "b2_launches": {f"node{i}": n["b2_launches"] for i, n in enumerate(nodes)},
        "rx_server": {"node3": byz["rx_server"],
                      **{f"node{i}": n["rx_server"] for i, n in enumerate(nodes)}},
        "reactor": {"node3": byz["reactor"], **{f"node{i}": n["reactor"] for i, n in enumerate(nodes)}},
    }


def plain_stats(torch, local, remote, starts) -> dict:
    """The screen's statistics on CPU copies with the sums in float64 (a
    float32 sum on the CPU drifts by 1e-3 at 25M terms; the card's tree
    reductions do not), and ``leaf_ratio`` by the port's own float32 code
    there: maxima and one division, exact on either device."""
    from dpwa_tpu_torch.trust.screen import _leaf_max_ratio, stats_from_sums

    a, b = local.cpu(), remote.cpu().to(torch.float32)
    a64, b64 = a.double(), b.double()
    sums = [torch.linalg.vector_norm(a64), torch.linalg.vector_norm(b64), torch.dot(a64, b64),
            torch.linalg.vector_norm((b - a).double())]
    return stats_from_sums([float(x) for x in sums] + [float(_leaf_max_ratio(a, b, starts))])


def trust_screen(torch, device, flush) -> dict:
    """The trust screen on the card at the TCP paths' replicas (SmallNet's
    66,410 floats, ResNet-50's 25,557,032), each segmented by its model's
    leaf sizes in the reference's order: an honest remote (a perturbed
    copy) and a sign-flip, each held against the plain version on CPU
    copies (:func:`plain_stats`): ``norm_ratio`` and ``update_ratio``
    within ``SCREEN_RTOL``, ``cosine`` within it absolutely, ``leaf_ratio``
    equal.  Timed with CUDA events, L2 flushed: the sums alone (device
    time, no readback) and the whole ``payload_stats`` (with its one
    readback), beside the bound (both vectors read once); and on the host
    clock the guard's checks and the screen read back apart (two syncs)
    and together (one, as the transport does)."""
    from dpwa_tpu_torch.models import mnist
    from dpwa_tpu_torch.recovery.guard import payload_check_tensors, payload_checks
    from dpwa_tpu_torch.trust.screen import leaf_starts_from_sizes, payload_stats, payload_sums
    from dpwa_tpu_torch.utils.pytree import leaf_sizes

    out = {}
    for name, d, which in SCREEN_CASES:
        if which == "mnist":
            from dpwa_tpu_torch.data import load_mnist_or_digits

            model = mnist.build_model(load_mnist_or_digits()[0].shape[1:])
            shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        else:
            shapes = resnet_shapes(True, "meta")
        sizes = leaf_sizes({k: torch.empty(v, device="meta") for k, v in shapes.items()})
        starts = leaf_starts_from_sizes(sizes, d)
        if starts is None:
            raise AssertionError(f"trust_screen: {name}'s leaves make {sum(sizes)}, not {d}")
        gen = torch.Generator(device=device).manual_seed(5)
        local = torch.randn(d, generator=gen, device=device)
        honest = local + 0.01 * torch.randn(d, generator=gen, device=device)
        case = {"d": d, "leaves": len(sizes)}
        for label, remote in (("honest", honest), ("sign_flip", -local)):
            got = payload_stats(local, remote, starts)
            want = plain_stats(torch, local, remote, starts)
            errs = {k: abs(got[k] - want[k]) / (abs(want[k]) if k != "cosine" else 1.0)
                    for k in ("norm_ratio", "update_ratio", "cosine")}
            if max(errs.values()) > SCREEN_RTOL or got["leaf_ratio"] != want["leaf_ratio"]:
                raise AssertionError(f"trust_screen {name} {label}: {got} vs the plain {want}")
            case[label] = {"stats": got, "errors": errs}
        nbytes = 2 * d * 4
        case["ms"] = time_ms(torch, lambda: payload_sums(local, honest, starts), 20, flush)
        case["stats_ms"] = time_ms(torch, lambda: payload_stats(local, honest, starts), 20, flush)
        case["bound_ms"], case["bound_by"] = bound_ms(nbytes, 8.0 * d)

        # The fetch path's guard and screen: two readbacks, or the guard's
        # scalars and the screen's read back together (the transport's
        # way); host clock around each call, the card drained before.
        def two_syncs():
            payload_checks(honest)
            payload_stats(local, honest, starts)

        def one_sync():
            torch.cat([payload_check_tensors(honest),
                       payload_sums(local, honest, starts).double()]).tolist()

        for label, fn in (("guard_then_screen_ms", two_syncs), ("guard_with_screen_ms", one_sync)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            case[label] = (time.perf_counter() - t0) * 1e3 / 50
        # The host's time to enqueue the sums (near the device time only if
        # something in them waits for the card).
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload_sums(local, honest, starts)
        case["enqueue_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        out[name] = case
        del local, honest
    out["host"] = plane_host_ms(torch)
    torch.cuda.empty_cache()
    return out


def plane_host_ms(torch) -> dict:
    """The planes' host work a round, on the host clock (no card): the
    trust policy on the five scalars (``TrustManager.screen`` with the
    statistics given: the median/MAD windows) and a membership round of a
    2-node view (the digest's encode at publish, its merge at fetch, the
    round's end), each the mean of 300 rounds."""
    import numpy as np

    from dpwa_tpu_torch.health.scoreboard import Scoreboard
    from dpwa_tpu_torch.membership.manager import MembershipManager
    from dpwa_tpu_torch.trust.manager import TrustManager
    from dpwa_tpu_torch.trust.screen import stats_from_sums

    rng = np.random.default_rng(0)
    trust = TrustManager(2, 0)
    vec = torch.zeros(4)
    sums = [[100.0, 100.0 + rng.random(), 9999.0, 1.0 + rng.random(), 1.0] for _ in range(300)]
    t0 = time.perf_counter()
    for r, row in enumerate(sums):
        trust.screen(1, vec, float(r), vec, round=r, stats=stats_from_sums(row))
    policy_ms = (time.perf_counter() - t0) * 1e3 / len(sums)
    views = [MembershipManager(2, i, Scoreboard(2, i)) for i in range(2)]
    t0 = time.perf_counter()
    for r in range(300):
        blob = views[1].encode(r)
        views[0].merge(blob, round=r)
        views[0].end_round(r)
    return {"trust_policy_ms": policy_ms,
            "membership_round_ms": (time.perf_counter() - t0) * 1e3 / 300}


def state_exchange(torch, device) -> dict:
    """The recovery plane's costs at ResNet-50's vector (25,557,032 floats
    on the card, as ``tcp_exchange``): ``pack_state`` of the replica (the
    readback, then the pack), a lazy publish (what a round pays when the
    state is packed at the first request), one whole STATE transfer over
    loopback in 1 MiB chunks (pre-packed, and packed lazily at its first
    chunk), the unpack and the landing on the card (one copy and one
    scatter, as the adapter lands a bootstrap), a push and a rollback of
    the ring on the card, and the local guard; the landing and the
    rollback held bit for bit."""
    from dpwa_tpu_torch.config import FlowctlConfig, RecoveryConfig
    from dpwa_tpu_torch.adapters.tcp_adapter import _packer
    from dpwa_tpu_torch.parallel import tcp
    from dpwa_tpu_torch.recovery import RollbackRing, pack_state, unpack_state, validate_payload

    gen = torch.Generator(device=device).manual_seed(41)
    vec = torch.randn(R50_D, generator=gen, device=device)
    meta = {"kind": "tcp_adapter", "clock": 100.0, "step": 100, "loss": 0.5}

    def host_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters, out

    readback_ms, host = host_ms(lambda: vec.cpu(), 3)
    pack_ms, blob = host_ms(lambda: pack_state([host], meta=meta), 3)
    eager_ms, _ = host_ms(lambda: pack_state([vec.cpu()], meta=meta), 3)
    # Admission on, its token bucket sized for this phase's eight back-to-
    # back transfers (98 connections each, from one host in seconds): the
    # default burst of 200 would shed the third with busy frames, which a
    # STATE fetch reads as short reads.  A bootstrap is one transfer.
    srv = tcp.PeerServer("127.0.0.1", 0, flowctl=FlowctlConfig(token_burst=1024.0))
    try:
        lazy_publish_ms, _ = host_ms(lambda: srv.publish_state(_packer(vec, meta)), 20)
        srv.publish_state(blob)
        chunk = RecoveryConfig().state_chunk_bytes
        transfer_ms, (got, outcome, _lat, nrx) = host_ms(
            lambda: tcp.fetch_state("127.0.0.1", srv.port, 10000, chunk_bytes=chunk), 3)
        if outcome != "success" or got != blob:
            raise AssertionError(f"state_exchange: the STATE transfer gave {outcome}")

        def lazy_transfer():
            srv.publish_state(_packer(vec, meta))
            return tcp.fetch_state("127.0.0.1", srv.port, 10000, chunk_bytes=chunk)

        lazy_transfer_ms, lazy = host_ms(lazy_transfer, 3)
        if lazy[0] != blob:
            raise AssertionError("state_exchange: the lazily packed state differs from pack_state's")
    finally:
        srv.close()
    unpack_ms, (leaves, _meta) = host_ms(lambda: unpack_state(got), 3)
    order = torch.arange(R50_D, device=device)
    flat = torch.empty(R50_D, device=device)

    def land():
        flat.index_copy_(0, order, torch.from_numpy(leaves[0]).to(device))

    landing_ms, _ = host_ms(land, 3)
    if not torch.equal(flat.view(torch.int32), vec.view(torch.int32)):
        raise AssertionError("state_exchange: the landed replica differs from the packed one")
    ring = RollbackRing(RecoveryConfig().snapshot_ring)
    ring.push(vec, 0, 0.0, 0.0)  # the slots are made at the first push
    push_ms = cuda_event_ms(torch, lambda: ring.push(vec, 1, 1.0, 0.5), 10)

    rollbacks = []
    for i in range(5):  # each rollback timed alone, after a push outside its window
        ring.push(vec, 2 + i, 2.0 + i, 0.5)
        flat.zero_()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        flat.copy_(ring.rollback().vec)
        end.record()
        torch.cuda.synchronize()
        rollbacks.append(start.elapsed_time(end))
    rollback_ms = sorted(rollbacks)[len(rollbacks) // 2]
    if not torch.equal(flat.view(torch.int32), vec.view(torch.int32)):
        raise AssertionError("state_exchange: the rolled-back replica differs from the pushed one")
    rec = RecoveryConfig()
    guard_ms, verdict = host_ms(lambda: validate_payload(vec, 0.5, rec), 10)
    if verdict is not None:
        raise AssertionError(f"state_exchange: the guard refused a sane replica: {verdict}")
    # What a recovery round adds on the host at train_tcp's d (SmallNet,
    # 66,410 floats): the local guard (a sync and two scalars back), the
    # ring push, the lazy state publish, and the eager pack it replaces;
    # the scoreboard's record of the fetch outcome.
    from dpwa_tpu_torch.health import Scoreboard

    small = torch.randn(MNIST_D, generator=gen, device=device)
    small_ring = RollbackRing(RecoveryConfig().snapshot_ring)
    small_ring.push(small, 0, 0.0, 0.0)
    board = Scoreboard(2, 0)
    srv = tcp.PeerServer("127.0.0.1", 0)
    try:
        mnist_round = {
            "d": MNIST_D,
            "guard_ms": host_ms(lambda: validate_payload(small, 0.5, rec), 50)[0],
            "ring_push_ms": host_ms(lambda: small_ring.push(small, 1, 1.0, 0.5), 50)[0],
            "lazy_publish_ms": host_ms(lambda: srv.publish_state(_packer(small, meta)), 50)[0],
            "eager_pack_ms": host_ms(lambda: pack_state([small.cpu()], meta=meta), 20)[0],
            "scoreboard_record_ms": host_ms(lambda: board.record(1, "success", 1e-3, 265640, 1),
                                            200)[0],
        }
    finally:
        srv.close()
    nbytes = R50_D * 4
    return {
        "mnist_round": mnist_round,
        "d": R50_D, "blob_bytes": len(blob), "chunk_bytes": chunk,
        "chunks": -(-len(blob) // chunk), "bytes_received": nrx,
        "readback_ms": readback_ms, "pack_ms": pack_ms, "eager_pack_ms": eager_ms,
        "lazy_publish_ms": lazy_publish_ms, "transfer_ms": transfer_ms,
        "lazy_transfer_ms": lazy_transfer_ms, "unpack_ms": unpack_ms, "landing_ms": landing_ms,
        "ring_push_ms": push_ms, "ring_rollback_ms": rollback_ms,
        "ring_push_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
        "guard_ms": guard_ms, "guard_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }


def tcp_exchange(torch, merge, device, wire: str, rx: str = "threaded",
                 rounds=(TCP_WARMUPS, TCP_PASSES, TCP_ITERS)) -> dict:
    """``bench.py``'s TCP leg on the card: two nodes in this process on
    port 0 serving from the ``rx`` Rx server, each with a device-resident
    replica of ResNet-50's d; ``rounds`` = (warm-up rounds, passes, rounds
    a pass), by default 3 warm-up rounds, then 3 passes of 10 lock-step
    rounds (both publish, then both exchange on their own threads); a round's clock starts after the publishes, as bench's, and
    stops when both merges are done on the card; GB/s per peer as bench
    counts it (2·d·4 bytes a round) from the median of the pass medians,
    and the median of the rounds' slower fetch (``last_fetch``'s
    ``latency_s``: connect to the payload and trailer read) and of what is
    left of the round after it (landing, guard, screen, B2).  Each exchange republishes its node's published
    replica from the host mirror: one readback a node a round.  The last
    round's merge is held bit for bit against the plain version on a CPU
    copy; the readback to publish, the landing copy and B2 are timed
    alone with CUDA events."""
    import threading

    import numpy as np

    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.device import handoff
    from dpwa_tpu_torch.device.engine import BF16_FORM, F32_FORM
    from dpwa_tpu_torch.device.replica import DeviceReplica, bf16_wire
    from dpwa_tpu_torch.parallel.tcp import TcpTransport

    cfg = make_local_config(2, schedule="ring", interpolation="constant", factor=0.3,
                            timeout_ms=10000, wire_dtype=wire, rx_server=rx)
    cfg = dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))
    nodes = [TcpTransport(cfg, f"node{i}", device=device) for i in range(2)]
    try:
        for t in nodes:
            for i, other in enumerate(nodes):
                t.set_peer_port(i, other.port)
        gen = torch.Generator(device=device).manual_seed(31)
        vecs = [torch.randn(R50_D, generator=gen, device=device) for _ in range(2)]
        merge.reset_launch_counts()  # count the exchange's launches only
        handoff.reset_handoff_stats()

        def one_round(step: int) -> tuple:
            """Both publish, then both exchange; the seconds from the
            exchanges' start to their merges done on the card (bench
            starts its clock after the publishes too)."""
            for i, t in enumerate(nodes):
                t.publish(vecs[i], step, 0)
            results = [None, None]

            def run(i):
                results[i] = nodes[i].exchange_on_device(vecs[i], step, 0, 0)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            torch.cuda.synchronize(device)
            elapsed = time.perf_counter() - t0
            if any(th.is_alive() for th in threads) or any(r is None or r[1] == 0.0 for r in results):
                raise AssertionError(f"tcp_exchange: round {step} did not merge: "
                                     f"{[t.last_fetch for t in nodes]}")
            return results, elapsed, max(t.last_fetch["latency_s"] for t in nodes)

        warmups, passes, iters = rounds
        for w in range(warmups):
            one_round(w)
        medians, fetches, rests = [], [], []
        for rep in range(passes):
            durations = []
            for it in range(iters):
                last, elapsed, fetch_s = one_round(warmups + rep * iters + it)
                durations.append(elapsed)
                fetches.append(fetch_s)
                rests.append(elapsed - fetch_s)
            medians.append(float(np.median(durations)))
        rounds = warmups + passes * iters
        launches = merge.gather_merge.launches
        stats = handoff.handoff_stats()
        if launches != 2 * rounds or merge.pair_merge_.launches != 0:
            raise AssertionError(f"tcp_exchange: {rounds} rounds on 2 nodes launched B2 {launches} times")
        # One readback a node a round: the exchange republishes the
        # publish's host mirror.
        if stats["d2h_readbacks"] != 2 * rounds:
            raise AssertionError(f"tcp_exchange: {rounds} rounds on 2 nodes read back "
                                 f"{stats['d2h_readbacks']} times")
        # The last round's merge on node 0 against the plain version.
        frame = bf16_wire(vecs[1]) if wire == "bf16" else vecs[1]
        form = BF16_FORM if wire == "bf16" else F32_FORM
        want = merge.torch_pairwise_merge(
            vecs[0].cpu()[None], torch.zeros(1, dtype=torch.int32),
            torch.tensor([last[0][1]]), wire=form, w=frame.cpu()[None])[0]
        same, err = nan_equal(torch, last[0][0].cpu(), want)
        if not same:
            raise AssertionError(f"tcp_exchange {wire}: the merged replica differs from the "
                                 f"plain version, max_abs_err={err}")
        # The round's device legs alone, with CUDA events.
        readback = cuda_event_ms(torch, lambda: DeviceReplica(vecs[0]).payload(wire), 5)
        host = DeviceReplica(vecs[1]).payload(wire)  # pinned, as a landing frame is
        landing = cuda_event_ms(torch, lambda: handoff.to_device(host, device), 5)
        partner = torch.zeros(1, dtype=torch.int32, device=device)
        alpha = torch.tensor([0.3], device=device)
        w = frame[None].contiguous()
        b2 = cuda_event_ms(torch, lambda: merge.gather_merge(vecs[0][None], partner, alpha,
                                                             wire=form, w=w), 10)
        median_s = float(np.median(medians))
        return {
            "wire": wire, "rx_server": type(nodes[0].server).__name__, "d": R50_D,
            "frame_bytes": R50_D * (2 if wire == "bf16" else 4),
            "gbps": 2 * R50_D * 4 / median_s / 1e9,
            "rep_gbps": [2 * R50_D * 4 / m / 1e9 for m in medians],
            "round_ms": median_s * 1e3, "pass_median_ms": [m * 1e3 for m in medians],
            "fetch_ms": float(np.median(fetches)) * 1e3,
            "after_fetch_ms": float(np.median(rests)) * 1e3,
            "warmups": warmups, "passes": passes, "iters": iters,
            "b2_launches": launches, "max_abs_err": err, "alpha": last[0][1],
            "readback_ms": readback, "landing_ms": landing, "b2_ms": b2,
            "frame_pinned": host.is_pinned(),
            "handoff": stats, "ring": nodes[0].ring.stats(),
            "outcomes": [t.stats["outcomes"] for t in nodes],
        }
    finally:
        for t in nodes:
            t.close()


def codec_kernel_checks(torch, merge, device, flush) -> dict:
    """The codec kernels at ResNet-50's d on the card, each against its
    plain version on the same inputs there: the int8 quantiser
    (``quantize_sr``, the whole code-4 body byte for byte, a zero chunk
    among the values), B2's int8-frame form and its support form at topk
    0.05's k (both bit for bit, NaN for NaN); then each timed with CUDA
    events, L2 flushed, beside its bound and its plain version, and beside
    what it replaces on the card: the dequantise-then-B2 route, and the row
    copy a dense or int8 shard merge pays; and B2's top-k form
    (:func:`topk_merge_checks`)."""
    from dpwa_tpu_torch.device import engine
    from dpwa_tpu_torch.ops import quantize as q

    d = R50_D
    chunks = q.n_chunks(d)
    gen = torch.Generator(device=device).manual_seed(41)
    x = torch.randn(d, generator=gen, device=device)
    y = torch.randn(d, generator=gen, device=device) * 3
    y[256:512] = 0.0
    k0, k1 = q._np_key_words(0, 7.5, 1)
    out = {}
    body = q.quantize_sr(y, k0, k1)
    plain = q.torch_quantize_sr(y, k0, k1)
    if not torch.equal(body, plain):
        raise AssertionError(f"quantize_sr differs from its plain version in "
                             f"{int((body != plain).sum())} bytes at d={d}")
    n_bytes = 4 * d + q.int8_nbytes(d)
    b_ms, b_by = bound_ms(n_bytes, 6 * d + 2 * chunks)
    ms = time_ms(torch, lambda: q.quantize_sr(y, k0, k1), 10, flush)
    out["quantize_sr"] = {
        "shape": [d], "bytes": n_bytes, "max_abs_err": 0.0, "ms": ms,
        "plain_ms": time_ms(torch, lambda: q.torch_quantize_sr(y, k0, k1), 2, flush),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
    }
    payload = q.Int8Payload(d, body)
    scales, codes = payload.views()
    got = merge.int8_frame_merge(x, codes, scales, 0.3)
    same, err = nan_equal(torch, got, merge.torch_int8_frame_merge(x, codes, scales, 0.3))
    if not same:
        raise AssertionError(f"b2 int8-frame form differs from its plain version: {err}")
    res = torch.empty_like(x)
    n_bytes = 9 * d + 4 * chunks
    b_ms, b_by = bound_ms(n_bytes, 4 * d)
    ms = time_ms(torch, lambda: merge.int8_frame_merge(x, codes, scales, 0.3, out=res), 10, flush)
    out["b2_int8_frame"] = {
        "shape": [1, d], "bytes": n_bytes, "max_abs_err": err, "ms": ms,
        "plain_ms": time_ms(torch, lambda: merge.torch_int8_frame_merge(x, codes, scales, 0.3),
                            3, flush),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
        "dequantise_then_b2_ms": time_ms(
            torch, lambda: engine.merge_dense(x, payload.dequantize(), 0.3), 10, flush),
    }
    k = q.topk_k(d, 0.05)
    idx = torch.sort(torch.randperm(d, generator=gen, device=device)[:k]).values.to(torch.int32)
    vals = torch.randn(k, generator=gen, device=device)
    base = x * 2
    got = merge.support_merge_(base.clone(), x, idx, vals, 0.3)
    same, err = nan_equal(torch, got, merge.torch_support_merge_(base.clone(), x, idx, vals, 0.3))
    if not same:
        raise AssertionError(f"b2 support form differs from its plain version: {err}")
    n_bytes = 16 * k
    b_ms, b_by = bound_ms(n_bytes, 3 * k)
    ms = time_ms(torch, lambda: merge.support_merge_(base, x, idx, vals, 0.3), 10, flush)
    out["b2_support"] = {
        "shape": [1, d], "k": k, "bytes": n_bytes, "max_abs_err": err, "ms": ms,
        "plain_ms": time_ms(torch, lambda: merge.torch_support_merge_(base, x, idx, vals, 0.3),
                            3, flush),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
        "row_copy_ms": time_ms(torch, lambda: x.clone(), 10, flush),
        "row_copy_bound_ms": bound_ms(8 * d, 0)[0],
    }
    out["topk_merge"] = topk_merge_checks(torch, merge, device, flush, x, gen)
    del x, y, body, plain, payload, got, res, base
    torch.cuda.empty_cache()
    return out


def topk_merge_checks(torch, merge, device, flush, x, gen) -> dict:
    """B2's top-k form at ResNet-50's d for each of TOPK_MERGE_CASES: bit-equal
    to its plain version on the card (NaN for NaN, inf and NaN among x and
    the values), and to the route it replaced (B2's self-lerp of the row,
    then the support form; for a shard frame a row copy, the slice's
    self-lerp, then the support), then each timed with CUDA events, L2
    flushed, beside its 8·d + 8·k bound, its plain version and that route,
    in this call; and the engine's whole merge from a landed frame's int64
    indices (their int32 copy included)."""
    from dpwa_tpu_torch.device import engine
    from dpwa_tpu_torch.ops import quantize as q
    from dpwa_tpu_torch.ops import shard
    from dpwa_tpu_torch.parallel import protocol_constants as pc

    d = x.numel()
    x = x.clone()
    x[[5, d // 2, d - 3]] = torch.tensor([float("inf"), float("nan"), float("-inf")], device=device)
    partner = torch.zeros(1, dtype=torch.int32, device=device)
    alpha = torch.full((1,), 0.3, dtype=torch.float32, device=device)

    def replaced(idx, vals, lo, hi):
        dst = x.clone() if (lo, hi) != (0, d) else torch.empty_like(x)
        merge.gather_merge(x[None, lo:hi], partner, alpha, wire="int8", lerp_self=True,
                           out=dst[None, lo:hi])
        merge.support_merge_(dst[lo:hi], x[lo:hi], idx, vals, 0.3)
        return dst

    res = {}
    for name, fraction, shards in TOPK_MERGE_CASES:
        lo, hi = shard.shard_bounds(d, shards, shards - 1) if shards > 1 else (0, d)
        k = q.topk_k(hi - lo, fraction)
        idx = torch.sort(torch.randperm(hi - lo, generator=gen, device=device)[:k]).values
        idx = idx.to(torch.int32)
        vals = torch.randn(k, generator=gen, device=device)
        vals[:2] = torch.tensor([float("nan"), float("inf")], device=device)
        got = merge.topk_merge(x, idx, vals, 0.3, lo, hi)
        same, err = nan_equal(torch, got, merge.torch_topk_merge(x, idx, vals, 0.3, lo, hi))
        if not same:
            raise AssertionError(f"topk_merge {name} differs from its plain version: {err}")
        if not nan_equal(torch, got, replaced(idx, vals, lo, hi))[0]:
            raise AssertionError(f"topk_merge {name} differs from the route it replaced")
        n_bytes = 8 * d + 8 * k
        b_ms, b_by = bound_ms(n_bytes, 3 * (hi - lo) + 3 * k)
        ms = time_ms(torch, lambda: merge.topk_merge(x, idx, vals, 0.3, lo, hi), 10, flush)
        frame = q.TopkPayload(hi - lo, idx.long(), vals)
        if shards > 1:
            frame = shard.ShardPayload(d, shards, shards - 1, pc.PAYLOAD_TOPK_DELTA, frame)
        whole = engine.merge_shard_topk if shards > 1 else engine.merge_topk
        res[name] = {
            "shape": [d], "slice": [lo, hi], "k": k, "bytes": n_bytes, "max_abs_err": err,
            "ms": ms, "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
            "plain_ms": time_ms(torch, lambda: merge.torch_topk_merge(x, idx, vals, 0.3, lo, hi),
                                3, flush),
            "library_ms": None,
            "replaced_route_ms": time_ms(torch, lambda: replaced(idx, vals, lo, hi), 10, flush),
            "engine_ms": time_ms(torch, lambda: whole(x, frame, 0.3), 10, flush),
        }
    return res


def wire_frame_bytes(q, d: int, kw: dict) -> int:
    """A frame's payload bytes at ``d`` under a WIRE_LEGS setting, from the
    layouts (every shard has the same length here: d % 8 == 0)."""
    k = kw.get("shard", {}).get("k", 1)
    m = d // k
    if kw.get("wire_codec") == "topk":
        inner = q.topk_nbytes(m, q.topk_k(m, kw["topk_fraction"]), "int8")
    else:
        inner = {"f32": 4 * m, "bf16": 2 * m, "int8": q.int8_nbytes(m)}[kw.get("wire_dtype", "f32")]
    return inner + (17 if k > 1 else 0)


def wire_exchange(torch, merge, device) -> dict:
    """``bench.py``'s ``bench_wire`` and ``bench_shard`` on the card: for
    each of WIRE_LEGS, two nodes in this process on port 0 with replicas of
    ResNet-50's d on the card, lock-step (both publish, then both exchange
    through ``exchange_on_device`` on their own threads; flowctl off, so a
    round that outlasts the other legs' latencies is not cut by an adaptive
    deadline learned on them), 2 warm-up rounds
    then 2 passes of 5; the exchange ms from the median of the pass
    medians, the wire bytes a frame from ``wire_snapshot()`` (held to the
    layout), the compression ratio, every round merged with finite
    replicas, the kernels' launches; the encode, readback and landing of
    one frame timed alone with CUDA events."""
    import threading

    import numpy as np

    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.device import handoff
    from dpwa_tpu_torch.device.replica import bf16_wire
    from dpwa_tpu_torch.ops import quantize as q
    from dpwa_tpu_torch.parallel.tcp import TcpTransport

    legs = {}
    for name, kw in WIRE_LEGS:
        t0 = time.perf_counter()
        cfg = make_local_config(2, schedule="ring", interpolation="constant", factor=0.3,
                                timeout_ms=20000, disabled_planes=("flowctl",), **kw)
        cfg = dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))
        nodes = [TcpTransport(cfg, f"node{i}", device=device) for i in range(2)]
        try:
            for t in nodes:
                for i, other in enumerate(nodes):
                    t.set_peer_port(i, other.port)
            gen = torch.Generator(device=device).manual_seed(51)
            vecs = [torch.randn(R50_D, generator=gen, device=device) for _ in range(2)]
            merge.reset_launch_counts()

            def one_round(step: int) -> float:
                for i, t in enumerate(nodes):
                    t.publish(vecs[i], step, 0)
                results = [None, None]

                def run(i):
                    results[i] = nodes[i].exchange_on_device(vecs[i], step, 0, step)

                start = time.perf_counter()
                threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=120)
                torch.cuda.synchronize(device)
                elapsed = time.perf_counter() - start
                if any(th.is_alive() for th in threads) or any(r is None or r[1] == 0.0 for r in results):
                    raise AssertionError(f"wire_exchange {name}: round {step} did not merge: "
                                         f"{[t.last_fetch for t in nodes]}")
                for i in range(2):
                    vecs[i] = results[i][0]
                return elapsed

            for w in range(WIRE_WARMUPS):
                one_round(w)
            medians = []
            for rep in range(WIRE_PASSES):
                durations = [one_round(WIRE_WARMUPS + rep * WIRE_ITERS + it) for it in range(WIRE_ITERS)]
                medians.append(float(np.median(durations)))
            rounds = WIRE_WARMUPS + WIRE_PASSES * WIRE_ITERS
            if not all(bool(torch.isfinite(v).all()) for v in vecs):
                raise AssertionError(f"wire_exchange {name}: a replica is not finite")
            snap = nodes[0].wire_snapshot()
            per_frame = snap["wire_bytes"] / max(snap["frames"], 1)
            layout = wire_frame_bytes(q, R50_D, kw)
            if per_frame != layout:
                raise AssertionError(f"wire_exchange {name}: {per_frame} bytes a frame, the layout "
                                     f"says {layout}")
            launches = {"gather_merge": merge.gather_merge.launches,
                        "int8_frame_merge": merge.int8_frame_merge.launches,
                        "topk_merge": merge.topk_merge.launches,
                        "support_merge_": merge.support_merge_.launches,
                        "quantize_sr": q.quantize_sr.launches}
            # One merge launch a merged round: the top-k form on a top-k
            # wire, B2 or its int8-frame form on the others.
            topk = 2 * rounds if kw.get("wire_codec") == "topk" else 0
            b2 = launches["gather_merge"] + launches["int8_frame_merge"]
            if device.type == "cuda" and (b2 != 2 * rounds - topk or launches["topk_merge"] != topk
                                          or launches["support_merge_"]):
                raise AssertionError(f"wire_exchange {name}: {rounds} rounds on 2 nodes, {launches}")
            # One frame's legs alone: encode on the card, read back, land.
            node, vec = nodes[0], vecs[0]
            if node._codec:
                encode = lambda: node.codec_body(vec, 99.0)[0]
            else:
                encode = lambda: bf16_wire(vec) if node.wire == "bf16" else vec
            encode_ms = cuda_event_ms(torch, encode, 3)
            body = encode()
            readback = cuda_event_ms(torch, lambda: handoff.to_host(body), 5)
            host = handoff.to_host(body)
            landing = cuda_event_ms(torch, lambda: handoff.to_device(host, device), 5)
            median_s = float(np.median(medians))
            legs[name] = {
                "setting": kw, "codec": snap["codec"], "wire_bytes_per_frame": per_frame,
                "layout_bytes": layout, "compression_ratio": snap["compression_ratio"],
                "reduction_vs_f32": 4 * R50_D / per_frame,
                "exchange_ms": median_s * 1e3 / 2, "round_ms": median_s * 1e3,
                "pass_median_ms": [m * 1e3 for m in medians], "rounds": rounds,
                "encode_ms": encode_ms, "readback_ms": readback, "landing_ms": landing,
                "launches": launches, "outcomes": [t.stats["outcomes"] for t in nodes],
                "verdicts": [t.stats["verdicts"] for t in nodes],
                "shard": snap.get("shard"), "seconds": time.perf_counter() - t0,
            }
        finally:
            for t in nodes:
                t.close()
            del vecs
            torch.cuda.empty_cache()
    return {"d": R50_D, "warmups": WIRE_WARMUPS, "passes": WIRE_PASSES, "iters": WIRE_ITERS,
            "legs": legs}


def codecs_tcp(kind: str) -> dict:
    """The MNIST example over TCP (two OS processes on a copy of
    examples/mnist/nodes.yaml, 300 steps, the default planes, a start and an
    end barrier) under each of CODEC_RUNS, and two processes of ``examples/mnist_torch.py`` (the
    reference's PyTorch surface) on the int8 wire, all at once: every node
    at accuracy >= 0.9, its B2 launches equal to its merged rounds; the
    quantiser launched under int8; on a top-k wire (whole-row or shard) B2's
    top-k form once a merged round and no other merge launch."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    try:
        for name, (protocol, blocks) in CODEC_RUNS.items():
            config = tcp_config(os.path.join(HERE, "build", f"codecs_tcp_{name}"), extra=blocks,
                                protocol=protocol)
            barrier = os.path.join(HERE, "build", f"codecs_tcp_{name}", "barrier")
            procs[name] = [mnist_node(config, f"node{i}", MNIST_STEPS, ("--barrier", barrier), env=env)
                           for i in range(2)]
        config = tcp_config(os.path.join(HERE, "build", "codecs_tcp_mnist_torch"),
                            protocol=CODEC_RUNS["int8"][0])
        procs["mnist_torch"] = [subprocess.Popen(
            [sys.executable, "-m", "dpwa_tpu_torch.examples.mnist_torch", "--name", f"node{i}",
             "--config", config, "--steps", str(MNIST_STEPS)],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        ) for i in range(2)]
        outs = {name: [p.communicate(timeout=TCP_TIMEOUT_S) for p in ps] for name, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    res = {}
    for name in CODEC_RUNS:
        nodes = [node_result(f"codecs_tcp {name}", f"node{i}", p.returncode, *out, kind, MNIST_STEPS)
                 for i, (p, out) in enumerate(zip(procs[name], outs[name]))]
        for n in nodes:
            topk = n["merged_rounds"] if "topk" in name else 0
            if n["topk_launches"] != topk or n["b2_launches"] - n["topk_launches"] != (
                    n["merged_rounds"] - topk):
                raise AssertionError(f"codecs_tcp {name}: {n['merged_rounds']} merged rounds, "
                                     f"{n['topk_launches']} top-k and {n['b2_launches']} B2 "
                                     f"launches in all")
            if "int8" in name and n["quantize_launches"] < n["steps"]:
                raise AssertionError(f"codecs_tcp {name}: {n['quantize_launches']} quantiser launches")
            n.pop("losses", None)
        res[name] = nodes
    accs = []
    for i, (p, (stdout, stderr)) in enumerate(zip(procs["mnist_torch"], outs["mnist_torch"])):
        m = re.search(r"test accuracy: ([0-9.]+)", stdout)
        if p.returncode != 0 or m is None or float(m.group(1)) < 0.9:
            print(stdout[-3000:], stderr[-3000:], file=sys.stderr)
            raise AssertionError(f"mnist_torch node{i}: exit {p.returncode}, accuracy "
                                 f"{m.group(1) if m else None}")
        accs.append(float(m.group(1)))
    res["mnist_torch"] = {"wire": "int8", "steps": MNIST_STEPS, "accuracy": accs}
    for name in (*CODEC_RUNS, "mnist_torch"):
        shutil.rmtree(os.path.join(HERE, "build", f"codecs_tcp_{name}"), ignore_errors=True)
    return res


def fold_kernel_checks(torch, merge, device, flush) -> dict:
    """B2's fold form at ResNet-50's d for each k of FOLD_KS: bit-equal to
    its plain twin on a CPU copy (α ≠ 0.5), then timed with CUDA events, L2
    flushed, beside its bound, its plain twin on the card and the k B2
    launches one after the other that it replaces; and the fan-in round
    (``exchange_on_device_fold``) of FAN_IN_NODES nodes in this process on
    the card, the main path of the fold: its launch counts (set to 0 just
    before it), its merge bit-equal to the sequential B2 launches, its host
    time."""
    import numpy as np

    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.device import engine
    from dpwa_tpu_torch.parallel.tcp import TcpTransport

    d = R50_D
    gen = torch.Generator(device=device).manual_seed(43)
    x = torch.randn(d, generator=gen, device=device)
    rows_all = [torch.randn(d, generator=gen, device=device) for _ in range(max(FOLD_KS))]
    x_cpu, rows_cpu = x.cpu(), [r.cpu() for r in rows_all]
    out = {}
    for k in FOLD_KS:
        rows, alphas = rows_all[:k], [0.3 + 0.37 * i / k for i in range(k)]
        got = merge.fold_merge(x, rows, alphas)
        same, err = nan_equal(torch, got.cpu(), merge.torch_fold_merge(x_cpu, rows_cpu[:k], alphas))
        if not same:
            raise AssertionError(f"fold_merge k={k} differs from its plain twin: {err}")
        res = torch.empty_like(x)

        def sequential():
            y = x
            for r, a in zip(rows, alphas):
                y = engine.merge_dense(y, r, a)
            return y

        if not torch.equal(sequential(), got):
            raise AssertionError(f"fold_merge k={k} differs from {k} B2 launches")
        n_bytes = (k + 2) * 4 * d
        b_ms, b_by = bound_ms(n_bytes, 4 * k * d)
        ms = time_ms(torch, lambda: merge.fold_merge(x, rows, alphas, out=res), 10, flush)
        out[f"k{k}"] = {
            "k": k, "shape": [1, d], "bytes": n_bytes, "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(torch, lambda: merge.torch_fold_merge(x, rows, alphas), 3, flush),
            "sequential_b2_ms": time_ms(torch, sequential, 10, flush),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
        }
        del got, res
    del x, rows_all, x_cpu, rows_cpu
    torch.cuda.empty_cache()
    cfg = make_local_config(FAN_IN_NODES, interpolation="clock", factor=0.7, timeout_ms=10000)
    cfg = dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))
    nodes = [TcpTransport(cfg, f"node{i}", device=device) for i in range(FAN_IN_NODES)]
    try:
        for t in nodes:
            for i, other in enumerate(nodes):
                t.set_peer_port(i, other.port)
        vecs = [torch.randn(d, generator=gen, device=device) for _ in nodes]
        for i, (t, v) in enumerate(zip(nodes, vecs)):
            t.publish(v, i + 1.0, 0.5)
        peers = list(range(1, FAN_IN_NODES))
        merge.reset_launch_counts()
        t0 = time.perf_counter()
        merged, merges = nodes[0].exchange_on_device_fold(vecs[0], 1.0, 0.5, 0, peers)
        torch.cuda.synchronize(device)
        round_ms = (time.perf_counter() - t0) * 1e3
        launches = {"fold_merge": merge.fold_merge.launches,
                    "gather_merge": merge.gather_merge.launches}
        if [p for p, _a in merges] != peers or launches != {"fold_merge": 1, "gather_merge": 0}:
            raise AssertionError(f"fan-in round: merges {merges}, launches {launches}")
        want = vecs[0]
        for p, a in merges:
            want = engine.merge_dense(want, vecs[p], a)
        if not torch.equal(merged, want):
            raise AssertionError("fan-in round differs from the sequential B2 launches")
        out["fan_in"] = {"d": d, "frames": len(merges), "alphas": [a for _p, a in merges],
                         "launches": launches, "round_ms": round_ms,
                         "ring": nodes[0].ring.stats()}
    finally:
        for t in nodes:
            t.close()
    del vecs
    torch.cuda.empty_cache()
    return out


def run_nodes(phase: str, kind: str, n: int, protocol: str, steps: int = MNIST_STEPS,
              extra: str = "") -> list:
    """``n`` OS processes of the MNIST example over TCP on a copy of
    examples/mnist/nodes.yaml widened to ``n`` nodes with ``protocol`` lines
    and ``extra`` blocks, held at a start and an end barrier; their checked
    summaries."""
    workdir = os.path.join(HERE, "build", phase)
    config = tcp_config(workdir, n=n, extra=extra, protocol=protocol)
    barrier = os.path.join(workdir, "barrier")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    try:
        for i in range(n):
            procs.append(mnist_node(config, f"node{i}", steps, ("--barrier", barrier), env=env))
        outs = [p.communicate(timeout=TCP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    nodes = [node_result(phase, f"node{i}", p.returncode, *out, kind, steps)
             for i, (p, out) in enumerate(zip(procs, outs))]
    shutil.rmtree(workdir, ignore_errors=True)
    for node in nodes:
        node.pop("losses", None)
    return nodes


def overlap_tcp(torch, merge, device, kind: str) -> dict:
    """bench.py's overlap leg (``bench_wire``) on the card: 2 nodes in this
    process, each with a device-resident replica of ResNet-50's d on the f32
    wire, driven in turn (both publish, then node0 and node1 exchange);
    OVERLAP_ITERS lock-step rounds, then as many with ``overlap_prefetch``
    and, after each round, a compute stand-in of the lock-step exchange's
    median (a node's exchange: half the pair's wall).  Each leg's exchange
    ms, B2 launches (one a merged round), and the pipeline's ``overlap``
    tally; then the MNIST example over TCP with the pipeline, 2 processes."""
    import numpy as np

    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.parallel.tcp import TcpTransport

    gen = torch.Generator(device=device).manual_seed(47)
    base = [torch.randn(R50_D, generator=gen, device=device) for _ in range(2)]

    def leg(sleep_s: float, **kw) -> dict:
        cfg = make_local_config(2, schedule="ring", timeout_ms=10000, **kw)
        cfg = dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))
        nodes = [TcpTransport(cfg, f"node{i}", device=device) for i in range(2)]
        try:
            for t in nodes:
                for i, other in enumerate(nodes):
                    t.set_peer_port(i, other.port)
            vecs = [b.clone() for b in base]
            merge.reset_launch_counts()
            durs = []
            for it in range(OVERLAP_ITERS):
                for i, t in enumerate(nodes):
                    t.publish(vecs[i], it, 0.0)
                t0 = time.perf_counter()
                for i, t in enumerate(nodes):
                    merged, alpha, _ = t.exchange_on_device(vecs[i], it, 0.0, it)
                    if alpha != 0.0:
                        vecs[i] = merged
                torch.cuda.synchronize(device)
                durs.append(time.perf_counter() - t0)
                if sleep_s:
                    time.sleep(sleep_s)
            merged_rounds = sum(t.stats["merged"] for t in nodes)
            if merge.gather_merge.launches != merged_rounds or merged_rounds < OVERLAP_ITERS:
                raise AssertionError(f"overlap_tcp: {merged_rounds} merged rounds, "
                                     f"{merge.gather_merge.launches} B2 launches")
            if not all(bool(torch.isfinite(v).all()) for v in vecs):
                raise AssertionError("overlap_tcp: a replica went non-finite")
            return {
                "exchange_ms": float(np.median(durs)) * 1e3 / 2,
                "warm_exchange_ms": float(np.median(durs[1:])) * 1e3 / 2,
                "round_ms": [x * 1e3 for x in durs], "merged_rounds": merged_rounds,
                "b2_launches": merge.gather_merge.launches,
                "overlap": nodes[0].wire_snapshot().get("overlap"),
                "outcomes": [t.stats["outcomes"] for t in nodes],
                "ring": nodes[0].ring.stats(),
            }
        finally:
            for t in nodes:
                t.close()

    lock = leg(0.0)
    compute_s = max(lock["exchange_ms"] / 1e3, 0.002)
    pipe = leg(compute_s, overlap_prefetch=True)
    ov = pipe["overlap"]
    if ov["rounds"] != OVERLAP_ITERS or ov["prefetched"] < OVERLAP_ITERS - 2:
        raise AssertionError(f"overlap_tcp: the pipeline's tally {ov}")
    del base
    torch.cuda.empty_cache()
    return {"d": R50_D, "iters": OVERLAP_ITERS, "compute_stand_in_ms": compute_s * 1e3,
            "lockstep": lock, "prefetch": pipe, "hidden_frac": ov["hidden_frac"],
            "occupancy": ov["occupancy"], "prefetched": ov["prefetched"],
            "straddled": ov["straddled"],
            "mnist": run_nodes("overlap_tcp", kind, 2, OVERLAP_PROTOCOL)}


def async_tcp(torch, merge, device, kind: str) -> dict:
    """bench.py's ``bench_async`` at its defaults on the card: ASYNC_NODES
    nodes in this process on the ring with device-resident replicas of
    ASYNC_D floats, the last trickled at ASYNC_TRICKLE B/s by the chaos
    harness for the whole run, each node on its own thread publishing,
    computing ASYNC_COMPUTE_MS (a sleep) and exchanging ASYNC_ITERS times; a
    lock-step leg and an async leg (``async_rounds``), each with the honest
    nodes' round p50 and p99 (the exchange alone, its merges done on the
    card), and the async leg's merges, stale drops, shed frames, fold
    launches and frames (every merge a B2 launch or a fold's frame); then
    the MNIST example over TCP with async rounds, ASYNC_NODES processes."""
    import threading

    import numpy as np

    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.parallel.tcp import TcpTransport

    straggler = ASYNC_NODES - 1
    chaos = {"enabled": True, "trickle_windows": ((straggler, 0, ASYNC_ITERS),),
             "trickle_bytes_per_s": ASYNC_TRICKLE}
    gen = torch.Generator(device=device).manual_seed(0)
    base = [torch.randn(ASYNC_D, generator=gen, device=device) for _ in range(ASYNC_NODES)]

    def leg(**kw) -> dict:
        cfg = make_local_config(ASYNC_NODES, schedule="ring", timeout_ms=ASYNC_TIMEOUT_MS,
                                chaos=chaos, **kw)
        cfg = dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0) for n in cfg.nodes))
        nodes = [TcpTransport(cfg, f"node{i}", device=device) for i in range(ASYNC_NODES)]
        walls = [[] for _ in nodes]
        vecs = [b.clone() for b in base]
        errors = []

        def run_node(i, t):
            try:
                for it in range(ASYNC_ITERS):
                    t.publish(vecs[i], float(it), 0.0)
                    time.sleep(ASYNC_COMPUTE_MS / 1e3)
                    t0 = time.perf_counter()
                    merged, alpha, _ = t.exchange_on_device(vecs[i], float(it), 0.0, it)
                    torch.cuda.synchronize(device)
                    walls[i].append(time.perf_counter() - t0)
                    if alpha != 0.0:
                        vecs[i] = merged
            except BaseException as e:  # re-raised on the calling thread
                errors.append(e)

        try:
            for t in nodes:
                for i, other in enumerate(nodes):
                    t.set_peer_port(i, other.port)
            merge.reset_launch_counts()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=run_node, args=(i, t), daemon=True)
                       for i, t in enumerate(nodes)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            if errors or any(th.is_alive() for th in threads):
                raise AssertionError(f"async_tcp: a node failed: {errors}")
            total_s = time.perf_counter() - t0
            honest = [w for i, ws in enumerate(walls) if i != straggler for w in ws]
            stack = torch.stack(vecs).cpu().numpy()
            mean = stack.mean(axis=0)
            out = {
                "p50_ms": float(np.percentile(honest, 50)) * 1e3,
                "p99_ms": float(np.percentile(honest, 99)) * 1e3,
                "total_s": total_s,
                "final_rel_rms": float(np.sqrt(np.mean((stack - mean) ** 2))
                                       / (np.sqrt(np.mean(mean ** 2)) + 1e-12)),
                "launches": {"gather_merge": merge.gather_merge.launches,
                             "fold_merge": merge.fold_merge.launches},
                "outcomes": [t.stats["outcomes"] for t in nodes],
            }
            if nodes[0].async_engine is not None:
                for t in nodes:
                    t.async_engine.join_inflight(timeout_s=2.0)
                snaps = [t.async_engine.snapshot() for t in nodes]
                for key in ("merges", "stale_drops", "dup_drops", "shed", "fold_dispatches",
                            "fold_frames"):
                    out[key] = sum(sn[key] for sn in snaps)
                out["peak_held_bytes"] = [sn["peak_held_bytes"] for sn in snaps]
                if (merge.gather_merge.launches + out["fold_frames"] != out["merges"]
                        or merge.fold_merge.launches != out["fold_dispatches"]):
                    raise AssertionError(f"async_tcp: merges and launches disagree: {out}")
            if not np.isfinite(stack).all():
                raise AssertionError("async_tcp: a replica went non-finite")
            return out
        finally:
            for t in nodes:
                t.close()

    lock = leg()
    asy = leg(async_rounds={"enabled": True})
    del base
    return {"d": ASYNC_D, "iters": ASYNC_ITERS, "peers": ASYNC_NODES,
            "timeout_ms": ASYNC_TIMEOUT_MS, "straggler": straggler,
            "trickle_bytes_per_s": ASYNC_TRICKLE, "compute_ms": ASYNC_COMPUTE_MS,
            "lockstep": lock, "async": asy,
            "straggler_speedup": lock["p99_ms"] / max(asy["p99_ms"], 1e-6),
            "mnist": run_nodes("async_tcp", kind, ASYNC_NODES, ASYNC_PROTOCOL)}


def view_run(torch, merge, device, seed: int, view) -> dict:
    """One seeded run of ``view_tcp``: VIEW_NODES port ``TcpTransport``s in
    this process on port 0 (reactor Rx servers, the ring schedule, the
    default planes, ``membership.view`` at ``view``, or off for None), each
    a SmallNet replica on the card from ``fold_in(key(seed), i)``, driven in
    lock-step as ``tcp_exchange`` drives two but one node after another
    (every live node publishes, then each exchanges on the card in turn: a
    fixed order, so a rerun publishes the same frames).  Node VIEW_CLOSED
    closes at round VIEW_CLOSE_AT.  It records each frame's SHA-256, the
    peers in each digest, each plane's residency after each round (held to
    the cap plus the scoreboard's tombstones here), every fetch's partner,
    the round each node evicted the closed node, the merged rounds and the
    merge kernels' launches, and the live replicas' spread."""
    import hashlib

    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.membership import digest as digest_mod
    from dpwa_tpu_torch.models import mnist
    from dpwa_tpu_torch.parallel import protocol_constants as pc
    from dpwa_tpu_torch.parallel.tcp import TcpTransport
    from dpwa_tpu_torch.utils import prng

    n, closed = VIEW_NODES, VIEW_CLOSED
    cfg = make_local_config(n, schedule="ring", seed=seed, rx_server="reactor",
                            membership={} if view is None else {"view": dict(view, enabled=True)})
    cfg = dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(x, port=0) for x in cfg.nodes))
    nodes = []
    try:
        for i in range(n):
            nodes.append(TcpTransport(cfg, f"node{i}", device=device))
        for t in nodes:
            for i, other in enumerate(nodes):
                t.set_peer_port(i, other.port)
        model = mnist.build_model((8, 8, 1))
        vecs = [torch.cat([v.reshape(-1) for v in mnist.init(
            model, prng.fold_in(prng.key(seed), i), device).values()]) for i in range(n)]
        if vecs[0].numel() != MNIST_D:
            raise AssertionError(f"view_tcp: SmallNet has {vecs[0].numel()} floats, not {MNIST_D}")

        def spread(live):
            x = torch.stack([vecs[i] for i in live])
            return float((x - x.mean(0)).norm(dim=1).max())

        shas, fetched, evicted_at, residency = [], [], {}, {}
        max_entries = 0
        merge.reset_launch_counts()  # count the run's launches only
        t0 = time.perf_counter()
        for r in range(VIEW_ROUNDS):
            if r == VIEW_CLOSE_AT:
                nodes[closed].close()
                spread0 = spread([i for i in range(n) if i != closed])
            live = [i for i in range(n) if r < VIEW_CLOSE_AT or i != closed]
            for i in live:
                nodes[i].publish(vecs[i], float(r), 0.5)
            row = []
            for i in live:
                t = nodes[i]
                merged, alpha, _partner = t.exchange_on_device(vecs[i], float(r), 0.5, r)
                if alpha:
                    vecs[i] = merged
                frame = t.server._payload
                row.append(hashlib.sha256(frame).hexdigest())
                nbytes = pc.BLOB_HDR.unpack_from(frame, 0)[5]
                dg = digest_mod.decode_digest(frame[pc.BLOB_HDR.size + nbytes:])
                max_entries = max(max_entries, len(dg.entries) - 1)  # less the node itself
                if t.last_round["outcome"] is not None:
                    fetched.append((r, i, t.last_fetch["peer"]))
                for e in t.pop_membership_events():
                    if e["event"] == "peer_dead" and e["peer"] == closed:
                        evicted_at.setdefault(i, r)
                if view is not None:
                    m, tombstones = t.membership, len(t.scoreboard.evicted_peers())
                    with m._lock:
                        resident = (set(m._view) | set(m.partial._last_touch)) - m._evicted - m._capped
                    sizes = {"membership": len(resident - {t.me}),
                             "scoreboard": len(t.scoreboard.tracked_peers()),
                             "trust": len(t.trust.tracked_peers()),
                             "estimator": len(t._estimator.tracked_peers())}
                    for plane, size in sizes.items():
                        if size > view["state_cap"] + tombstones:
                            raise AssertionError(
                                f"view_tcp: node{i}'s {plane} holds {size} peers at round {r} "
                                f"(cap {view['state_cap']}, {tombstones} tombstones)")
                        residency[plane] = max(residency.get(plane, 0), size)
            shas.append(row)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        live = [i for i in range(n) if i != closed]
        out = {
            "shas": shas, "fetched": fetched, "evicted_at": evicted_at,
            "max_digest_peers": max_entries, "seconds": seconds,
            "merged_rounds": sum(t.stats["merged"] for t in nodes),  # the closed node's too
            "launches": {"gather_merge": merge.gather_merge.launches,
                         "pair_merge_": merge.pair_merge_.launches,
                         "other_merges": (merge.int8_frame_merge.launches
                                          + merge.topk_merge.launches + merge.fold_merge.launches)},
            "spread_at_close": spread0, "spread_end": spread(live), "peak_residency": residency,
            "digest_bytes": sorted({nodes[i].last_digest_nbytes for i in live}),
            "reactor_frames": sum(nodes[i].health_snapshot()["reactor"]["frames"] for i in live),
            "rx_server": type(nodes[0].server).__name__,
        }
        if view is not None:
            out["view"] = {i: nodes[i].wire_snapshot()["view"] for i in live}
        return out
    finally:
        for t in nodes:
            t.close()


def view_tcp(torch, merge, device, seed: int) -> dict:
    """The partial view on the card: :func:`view_run` under VIEW, then the
    same run view-off and at VIEW_IDENTITY.  Passes only if every merged
    round launched B2 once and no other merge, no digest carried more than
    ``digest_sample`` peers, no plane held more than ``state_cap`` peers
    beyond the tombstones after any round, both ring neighbours of the
    closed node evicted it as dead and one of them promoted a passive peer,
    no node fetched the closed node after evicting it, the live replicas'
    spread fell, and the identity run published the view-off run's frames,
    SHA-256 for SHA-256."""
    closed = VIEW_CLOSED
    runs = {name: view_run(torch, merge, device, seed, view)
            for name, view in (("view", VIEW), ("off", None), ("identity", VIEW_IDENTITY))}
    for name, run in runs.items():
        launches = run["launches"]
        if (run["merged_rounds"] < 1 or launches["gather_merge"] != run["merged_rounds"]
                or launches["pair_merge_"] or launches["other_merges"]):
            raise AssertionError(f"view_tcp {name}: {run['merged_rounds']} merged rounds "
                                 f"launched {launches}")
        if not run["spread_end"] < run["spread_at_close"]:
            raise AssertionError(f"view_tcp {name}: the spread went from {run['spread_at_close']} "
                                 f"to {run['spread_end']}")
        late = [(r, i) for r, i, peer in run["fetched"]
                if peer == closed and i in run["evicted_at"] and r > run["evicted_at"][i]]
        if late:
            raise AssertionError(f"view_tcp {name}: fetched node{closed} after evicting it: {late}")
    view = runs["view"]
    if view["max_digest_peers"] > VIEW["digest_sample"]:
        raise AssertionError(f"view_tcp: a digest carried {view['max_digest_peers']} peers")
    neighbours = ((closed - 1) % VIEW_NODES, (closed + 1) % VIEW_NODES)
    if not all(i in view["evicted_at"] for i in neighbours):
        raise AssertionError(f"view_tcp: node{closed}'s ring neighbours did not evict it: "
                             f"{view['evicted_at']}")
    promotions = {i: view["view"][i]["view_promotions"] for i in neighbours}
    if not any(promotions.values()):
        raise AssertionError(f"view_tcp: no ring neighbour of node{closed} promoted a passive "
                             f"peer: {promotions}")
    if runs["identity"]["shas"] != runs["off"]["shas"]:
        first = next(r for r, (a, b) in enumerate(zip(runs["identity"]["shas"], runs["off"]["shas"]))
                     if a != b)
        raise AssertionError(f"view_tcp: the identity view's frames differ from the view-off "
                             f"run's from round {first}")
    summary = {name: {k: v for k, v in run.items() if k not in ("shas", "fetched")}
               for name, run in runs.items()}
    return {
        "nodes": VIEW_NODES, "d": MNIST_D, "rounds": VIEW_ROUNDS, "closed": closed,
        "close_at": VIEW_CLOSE_AT, "view_config": VIEW, "identity_config": VIEW_IDENTITY,
        "seed": seed, "frames_compared": sum(len(row) for row in runs["off"]["shas"]),
        "identity_frames_equal": True, "neighbour_promotions": promotions,
        "b2_launches": {name: run["launches"]["gather_merge"] for name, run in runs.items()},
        **summary,
    }


def reactor_tcp(torch, kind: str, device) -> dict:
    """``train_tcp`` and ``byzantine_tcp`` rerun at once with
    ``protocol.rx_server: reactor`` (the byzantine rerun with a chaos block
    that draws no fault, so every node, node3 included, serves from the
    chaos reactor), with those phases' checks, and every process's server
    the reactor's."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pair_run = pool.submit(run_pair, "reactor_tcp_train", kind, MNIST_STEPS,
                               protocol=REACTOR_PROTOCOL)
        byz = byzantine_tcp(torch, kind, device, phase="reactor_tcp_byzantine",
                            protocol=REACTOR_PROTOCOL, blocks=REACTOR_CHAOS)
        pair = pair_run.result()
    servers = {"train": [n["rx_server"] for n in pair], "byzantine": byz["rx_server"]}
    if (servers["train"] != ["ReactorPeerServer"] * 2
            or set(byz["rx_server"].values()) != {"ChaosReactorPeerServer"}):
        raise AssertionError(f"reactor_tcp: served by {servers}")
    served = [n["reactor"]["frames"] for n in pair] + [r["frames"] for r in byz["reactor"].values()]
    if min(served) < 1:
        raise AssertionError(f"reactor_tcp: a reactor served no frame: {served}")
    return {"train": {"nodes": pair, "steps": MNIST_STEPS}, "byzantine": byz,
            "rx_server": servers, "frames_served": served}


def reactor_exchange(torch, merge, device) -> dict:
    """Where the host's time in a lock-step f32 round goes, under each Rx
    server: :func:`tcp_exchange` at ResNet-50's d with the threaded server
    and the reactor in turns (REACTOR_ORDER), each leg cut to
    REACTOR_WARMUPS warm-up rounds and REACTOR_PASSES passes of
    REACTOR_ITERS; each server's median round, fetch and remainder over its
    legs."""
    import numpy as np

    legs = []
    for rx in REACTOR_ORDER:
        res = tcp_exchange(torch, merge, device, "f32", rx=rx,
                           rounds=(REACTOR_WARMUPS, REACTOR_PASSES, REACTOR_ITERS))
        legs.append({k: res[k] for k in ("rx_server", "round_ms", "fetch_ms", "after_fetch_ms",
                                         "pass_median_ms", "b2_launches", "max_abs_err")})
        torch.cuda.empty_cache()
    out = {"order": list(REACTOR_ORDER), "legs": legs}
    for rx in ("threaded", "reactor"):
        mine = [leg for leg, name in zip(legs, REACTOR_ORDER) if name == rx]
        out[rx] = {key: float(np.median([leg[key] for leg in mine]))
                   for key in ("round_ms", "fetch_ms", "after_fetch_ms")}
    return out


def run_tool(script: str, paths, json_out: bool = True):
    """One of the repo's stdlib tools (``tools/<script>``) over ``paths`` as
    a subprocess: ``(exit code, its JSON report or its output)``."""
    cmd = [sys.executable, os.path.join(HERE, "tools", script), *(["--json"] if json_out else []),
           *paths]
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=120)
    if json_out and proc.returncode == 0:
        return proc.returncode, json.loads(proc.stdout)
    return proc.returncode, proc.stdout[-2000:] + proc.stderr[-2000:]


def obs_tcp(kind: str) -> dict:
    """``train_tcp``'s two MNIST processes (start and end barriers) with the
    whole obs block on and the adapter's metrics JSONL: every node at
    accuracy >= 0.9 with one B2 launch a merged round, a trace record a
    round, every JSONL file accepted by ``tools/schema_check.py``,
    ``tools/trace_report.py`` joining the two nodes' spans with completeness
    1.0 and a falling convergence estimate, ``tools/incident_report.py``
    finding no incident, and a flight dump each node left at its close."""
    workdir = os.path.join(HERE, "build", "obs_tcp")
    shutil.rmtree(workdir, ignore_errors=True)
    base = tcp_config(workdir)
    with open(base) as f:
        text = f.read()
    files = {name: [os.path.join(workdir, f"{name}-{i}.jsonl") for i in range(2)]
             for name in ("trace", "incidents", "flight", "metrics")}
    configs = []
    for i in range(2):
        configs.append(os.path.join(workdir, f"node{i}.yaml"))
        with open(configs[i], "w") as f:
            f.write(text + OBS_TCP.format(trace=files["trace"][i], incidents=files["incidents"][i],
                                          flight=files["flight"][i]))
    barrier = os.path.join(workdir, "barrier")
    procs = []
    try:
        for i in range(2):
            procs.append(mnist_node(configs[i], f"node{i}", MNIST_STEPS,
                                    ("--barrier", barrier, "--metrics", files["metrics"][i])))
        outs = [p.communicate(timeout=TCP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    nodes = [node_result("obs_tcp", f"node{i}", p.returncode, *out, kind, MNIST_STEPS)
             for i, (p, out) in enumerate(zip(procs, outs))]
    traced = []
    for i, n in enumerate(nodes):
        with open(files["trace"][i]) as f:
            recs = [json.loads(line) for line in f]
        rounds = sum(r["kind"] == "round" for r in recs)
        if rounds != n["rounds"]:
            raise AssertionError(f"obs_tcp: node{i} traced {rounds} of its {n['rounds']} rounds")
        traced.append({"rounds": rounds, "serves": sum(r["kind"] == "serve" for r in recs)})
    every = [p for paths in files.values() for p in paths if os.path.exists(p)]
    rc, schema = run_tool("schema_check.py", every)
    if rc != 0:
        raise AssertionError(f"obs_tcp: tools/schema_check.py exited {rc}: {schema}")
    rc, trace = run_tool("trace_report.py", files["trace"])
    if rc != 0:
        raise AssertionError(f"obs_tcp: tools/trace_report.py exited {rc}: {trace}")
    conv = trace["convergence"]
    if trace["join"]["completeness"] != 1.0 or not conv or not (
            conv[-1]["rms_mean"] < conv[0]["rms_mean"]):
        raise AssertionError(f"obs_tcp: trace join {trace['join']}, convergence "
                             f"{conv[:1]} .. {conv[-1:]}")
    rc, incidents = run_tool("incident_report.py", files["incidents"] + files["flight"])
    if rc != 0 or incidents["clusters"] or incidents["alerts"]:
        raise AssertionError(f"obs_tcp: a clean run's incident report: {incidents}")
    dumps = []
    for i, path in enumerate(files["flight"]):
        with open(path) as f:
            meta = json.loads(f.readline())
        if meta["reason"] != "close":
            raise AssertionError(f"obs_tcp: node{i}'s flight dump {meta}")
        dumps.append({"rounds": meta["rounds"], "dumps": meta["dumps"]})
    for n in nodes:
        n.pop("losses", None)
    shutil.rmtree(workdir, ignore_errors=True)
    return {
        "nodes": nodes, "steps_per_sec": [n["steps_per_sec"] for n in nodes],
        "traced": traced, "schema_records": schema["records"],
        "trace_join": trace["join"], "trace_stage_median_ms": trace["stage_median_ms"],
        "convergence_rms": [conv[0]["rms_mean"], conv[-1]["rms_mean"]],
        "convergence_rel": [conv[0]["rel_mean"], conv[-1]["rel_mean"]],
        "incident_clusters": len(incidents["clusters"]), "alerts": incidents["alerts"],
        "flight_dumps": dumps,
    }


def hier_tcp(kind: str) -> dict:
    """HIER_NODES OS processes of the MNIST example over TCP, two islands of
    four under HIER_TOPOLOGY: every node at accuracy >= 0.9 with one B2
    launch a merged round, every board naming node3 and node4 at term 0,
    every fetched frame carrying a v2 digest, and the only fetches across
    the islands node3's of node4 and node4's of node3, one in each wide
    slot (a step in three)."""
    nodes = run_nodes("hier_tcp", kind, HIER_NODES, "", extra=HIER_TOPOLOGY)
    island = {i: 0 if i < HIER_NODES // 2 else 1 for i in range(HIER_NODES)}
    wide_steps = sum(1 for s in range(MNIST_STEPS) if s % 3 == 2)
    across = []
    for i, n in enumerate(nodes):
        if n["leaders"] != HIER_LEADERS:
            raise AssertionError(f"hier_tcp: node{i}'s board {n['leaders']}")
        if n["digest_versions"] != {"2": n["outcomes"].get("success", 0)}:
            raise AssertionError(f"hier_tcp: node{i} fetched digests {n['digest_versions']} "
                                 f"in {n['outcomes']}")
        wide = {p: c for p, c in n["fetched_from"].items() if island[int(p)] != island[i]}
        leader = {3: "4", 4: "3"}.get(i)
        want = {leader: wide_steps} if leader is not None else {}
        if wide != want:
            raise AssertionError(f"hier_tcp: node{i} fetched across the islands {wide}, "
                                 f"expected {want}")
        across.append(sum(wide.values()))
    return {
        "nodes": nodes, "steps_per_sec": [n["steps_per_sec"] for n in nodes],
        "accuracy": [n["accuracy"] for n in nodes],
        "merged_rounds": [n["merged_rounds"] for n in nodes],
        "b2_launches": [n["b2_launches"] for n in nodes],
        "fetched_across": across, "wide_slots": wide_steps,
        "leaders": nodes[0]["leaders"],
        "digest_bytes": [n["digest_bytes"] for n in nodes],
    }


def hier_engine(torch, device) -> dict:
    """bench.py's island sweep with the simulator's replicas on the card:
    the flat ring and each island size, each leg run on the card and on the
    CPU with replicas of MNIST_D floats, the card's final replicas bit-equal
    to the CPU's, the frames and records equal, and the wide-area frames
    the flat ring's over the island size; then tests/test_hier.py's
    leader-kill episode, on the card and on the CPU: one succession (term
    1) and exactly one incident, a leader_failover."""
    from dpwa_tpu_torch.config import ObsConfig
    from dpwa_tpu_torch.hier import HierGossipEngine, Topology

    def run(where, topo, rounds, target=None, kill=None):
        eng = HierGossipEngine(topo.n_peers if topo else HIER_PEERS, dim=MNIST_D, seed=0,
                               topology=topo, device=where,
                               incidents=ObsConfig(incidents=True) if kill else None)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        if kill is None:
            res = eng.run(rounds, target_rel=target)
        else:
            for r in range(rounds):
                if r == kill:
                    eng.kill(eng.board.leader_of(1))
                eng.step(r)
            res = {"wide_frames": eng.wide_frames, "intra_frames": eng.intra_frames,
                   "incidents_opened": eng.incidents_opened,
                   "alerts": dict(eng.alerts_total)}
        torch.cuda.synchronize(device)
        return eng, res, time.perf_counter() - t0

    def leg(name, topo, rounds, target=None, kill=None):
        card, got, card_s = run(device, topo, rounds, target, kill)
        cpu, want, cpu_s = run("cpu", topo, rounds, target, kill)
        equal = torch.equal(card.replicas.cpu(), cpu.replicas)
        # rel_rms is reduced in another order on each device: within 1e-9,
        # relative or absolute (converged replicas spread by rounding noise).
        close = all(math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-9) for a, b in zip(
            got.get("history", ()), want.get("history", ())))
        exact = ("history", "final_rel_rms")
        same = close and {k: v for k, v in got.items() if k not in exact} == {
            k: v for k, v in want.items() if k not in exact}
        if not (equal and same and card.records == cpu.records
                and card.events_seen == cpu.events_seen):
            raise AssertionError(f"hier_engine {name}: the card's run left the CPU's "
                                 f"(replicas equal {equal}, counts equal {same})")
        out = {k: v for k, v in got.items() if k != "history"}
        out.update({"card_seconds": card_s, "cpu_seconds": cpu_s,
                    "card_ms_per_round": card_s / rounds * 1e3,
                    "cpu_ms_per_round": cpu_s / rounds * 1e3, "replicas_bit_equal": equal})
        return card, out

    legs = {"flat": leg("flat", None, HIER_ROUNDS, HIER_TARGET)[1]}
    for size in HIER_SIZES:
        name = f"{HIER_PEERS // size}x{size}"
        legs[name] = leg(name, Topology.uniform(HIER_PEERS // size, size), HIER_ROUNDS,
                         HIER_TARGET)[1]
        legs[name]["wide_multiplier"] = legs["flat"]["wide_frames"] / legs[name]["wide_frames"]
    wide = [v["wide_frames"] for v in legs.values()]
    mults = [v["wide_multiplier"] for v in list(legs.values())[1:]]
    if wide != [4096, 1024, 512, 256] or mults != [4.0, 8.0, 16.0]:
        raise AssertionError(f"hier_engine: wide frames {wide}, multipliers {mults}")
    eng, kill = leg("leader_kill", Topology.uniform(2, 4), HIER_KILL_ROUNDS, kill=HIER_KILL_AT)
    if (eng.board.term_of(1) != 1 or kill["incidents_opened"] != 1
            or kill["alerts"] != {"leader_failover": 1}):
        raise AssertionError(f"hier_engine: the leader kill gave term {eng.board.term_of(1)}, "
                             f"{kill['incidents_opened']} incidents, alerts {kill['alerts']}")
    kill.update({"leaders": eng.board.leaders(), "terms": [eng.board.term_of(g) for g in (0, 1)],
                 "events": eng.events_seen})
    return {"peers": HIER_PEERS, "dim": MNIST_D, "rounds": HIER_ROUNDS, "target": HIER_TARGET,
            "legs": legs, "wide_frames": wide, "wide_multipliers": mults,
            "rounds_to_target": {k: v["rounds_to_target"] for k, v in legs.items()},
            "leader_kill": kill}


def obs_exchange(torch, merge, device, flush) -> dict:
    """``tcp_exchange``'s lock-step f32 round at ResNet-50's d (2 nodes in
    this process, both publish, then both exchange on their own threads)
    with the obs block off and OBS_EXCHANGE on in turns (OBS_ORDER), every
    leg from the same seeded replicas: each on leg's frames equal to the
    first off leg's plus one DPWT trailer and its merged replicas bit-equal;
    each leg's median round; the traced stages' medians; one scrape of
    ``/metrics`` holding every plane's families; the sketch on the card
    against its plain float64 version within the float32 summation bound
    and timed (CUDA events, L2 flushed) beside its bound; then the prefetch
    pipeline with the trace on, under a compute stand-in of the off legs'
    median round: the unhidden time split by stage, and the span-derived
    hidden fraction against ``wire_snapshot``'s."""
    import threading
    import urllib.request

    import numpy as np

    from dpwa_tpu_torch.config import make_local_config
    from dpwa_tpu_torch.obs import sketch, wire
    from dpwa_tpu_torch.parallel.tcp import TcpTransport

    gen = torch.Generator(device=device).manual_seed(53)
    base = [torch.randn(R50_D, generator=gen, device=device) for _ in range(2)]
    first = {}  # the first off leg's frames (host copies) and merged replicas

    def nodes_of(obs, **kw):
        cfg = make_local_config(2, schedule="ring", interpolation="constant", factor=0.3,
                                timeout_ms=10000, obs=obs,
                                health={"healthz_port": 0} if obs.get("metrics") else None, **kw)
        cfg = dataclasses.replace(cfg, nodes=tuple(dataclasses.replace(n, port=0)
                                                   for n in cfg.nodes))
        nodes = [TcpTransport(cfg, f"node{i}", device=device) for i in range(2)]
        for t in nodes:
            for i, other in enumerate(nodes):
                t.set_peer_port(i, other.port)
        return nodes

    def leg(label: str, obs: dict, compute_s: float = 0.0, **kw) -> dict:
        nodes = nodes_of(obs, **kw)
        try:
            vecs = [b.clone() for b in base]
            merge.reset_launch_counts()
            durs, rounds = [], 0
            for it in range(OBS_WARMUPS + OBS_ROUNDS):
                for i, t in enumerate(nodes):
                    t.publish(vecs[i], it, 0.0)
                results = [None, None]

                def run(i):
                    results[i] = nodes[i].exchange_on_device(vecs[i], it, 0.0, it)

                t0 = time.perf_counter()
                threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=120)
                torch.cuda.synchronize(device)
                elapsed = time.perf_counter() - t0
                if any(th.is_alive() for th in threads) or any(
                        r is None or r[1] == 0.0 for r in results):
                    raise AssertionError(f"obs_exchange {label}: round {it} did not merge: "
                                         f"{[t.last_fetch for t in nodes]}")
                vecs = [r[0] for r in results]
                if it >= OBS_WARMUPS:
                    durs.append(elapsed)
                    if not compute_s:
                        check_frames(label, nodes, it - OBS_WARMUPS, bool(obs))
                if compute_s:
                    time.sleep(compute_s)
            merged_rounds = sum(t.stats["merged"] for t in nodes)
            if merge.gather_merge.launches != merged_rounds:
                raise AssertionError(f"obs_exchange {label}: {merged_rounds} merged rounds, "
                                     f"{merge.gather_merge.launches} B2 launches")
            if not compute_s:
                if "vecs" not in first:
                    first["vecs"] = vecs
                elif not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                             for a, b in zip(vecs, first["vecs"])):
                    raise AssertionError(f"obs_exchange {label}: the merged replicas differ "
                                         "from the first off leg's")
            out = {"leg": label, "round_ms": float(np.median(durs)) * 1e3,
                   "rounds_ms": [d * 1e3 for d in durs], "b2_launches": merged_rounds,
                   "fetch_ms": [t.last_fetch["latency_s"] * 1e3 for t in nodes]}
            if nodes[0].tracer is not None:
                recs = [r for t in nodes for r in t.tracer.pop_records() if r["kind"] == "round"]
                out["records"] = recs
                out["serve_spans"] = nodes[0].tracer.stage_summary().get("serve", {}).get("n", 0)
            if obs.get("metrics") and "scrape" not in first:
                first["scrape"] = scrape(nodes[0])
            if kw.get("overlap_prefetch"):
                ovs = [t.wire_snapshot()["overlap"] for t in nodes]
                out["overlap"] = ovs
            return out
        finally:
            for t in nodes:
                t.close()

    def check_frames(label, nodes, r, with_obs):
        for i, t in enumerate(nodes):
            with t.server._lock:
                segs = t.server._segments
            if with_obs:
                segs, trailer = segs[:-1], bytes(segs[-1])
                frame = wire.decode_obs(trailer)
                if frame is None or frame.trace_id != f"{i}:{OBS_WARMUPS + r}" or (
                        frame.sketch is None or frame.sketch.shape != (OBS_SKETCH_K,)):
                    raise AssertionError(f"obs_exchange {label}: node{i}'s trailer {frame}")
            views = [np.frombuffer(memoryview(s).cast("B"), np.uint8) for s in segs]
            key = (i, r)
            if "frames" not in first:
                first["frames"] = {}
            if key not in first["frames"]:
                if with_obs:
                    raise AssertionError("obs_exchange: an on leg ran before the first off leg")
                first["frames"][key] = [v.copy() for v in views]
            else:
                want = first["frames"][key]
                if len(want) != len(views) or not all(
                        np.array_equal(a, b) for a, b in zip(views, want)):
                    raise AssertionError(f"obs_exchange {label}: node{i}'s frame of round {r} "
                                         "is not the off leg's")

    def scrape(node) -> dict:
        url = f"http://127.0.0.1:{node.healthz.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            ctype, text = resp.headers["Content-Type"], resp.read().decode()
        families = sorted({line.split()[2] for line in text.splitlines()
                           if line.startswith("# TYPE ")})
        samples = 0
        for line in text.splitlines():
            if line and not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])
                samples += 1
        missing = sorted(set(OBS_FAMILIES) - set(families))
        if missing or not ctype.startswith("text/plain; version=0.0.4"):
            raise AssertionError(f"obs_exchange: /metrics ({ctype}) lacks {missing}")
        return {"families": len(families), "samples": samples, "bytes": len(text)}

    def medians(recs, stages) -> dict:
        return {s: float(np.median([r["stages"].get(s, 0.0) for r in recs])) * 1e3
                for s in stages}

    legs = [leg(label, OBS_EXCHANGE if label == "on" else {}) for label in OBS_ORDER]
    first.pop("frames", None)
    off_ms = float(np.median([x for leg_ in legs if leg_["leg"] == "off"
                              for x in leg_["rounds_ms"]]))
    on_ms = float(np.median([x for leg_ in legs if leg_["leg"] == "on"
                             for x in leg_["rounds_ms"]]))
    traced = [r for leg_ in legs for r in leg_.pop("records", []) if r["step"] >= OBS_WARMUPS]
    stage_ms = medians(traced, OBS_STAGES)
    # The sketch on the card: the complete blocks' batched product and the
    # last block's dot, against a float64 sum on the card.
    k, vec = OBS_SKETCH_K, base[0]
    signs = sketch.sketch_signs(0, R50_D, k, device)
    m = signs.shape[1]
    padded = torch.zeros(k * m, dtype=torch.float64, device=device)
    padded[:R50_D] = vec.double()
    want = (signs.double() * padded.view(k, m)).sum(1)
    bound_err = 2 * m * 2.0 ** -24 * padded.abs().view(k, m).sum(1)
    got = torch.from_numpy(sketch.replica_sketch(vec, 0, k)).to(device).double()
    err = (got - want).abs()
    if not bool((err <= bound_err).all()):
        raise AssertionError(f"obs_exchange: the sketch is off its plain version by {err.max()}")
    del padded, want
    sketch_ms = time_ms(torch, lambda: sketch.replica_sketch_tensor(vec, 0, k), 20, flush)
    # The complete blocks' projection in three plain-PyTorch forms: one
    # batched product over float32 signs, and a product then a row sum over
    # float32 or int8 signs (the signed replica a float32 temporary; the
    # port's form is the int8 one).
    full = R50_D // m
    v2d = vec[:full * m].view(full, m)
    signs_f32 = signs[:full].float()
    forms = {
        "bmm_f32": lambda: torch.bmm(signs_f32[:, None, :], v2d[:, :, None]),
        "mul_sum_f32": lambda: (signs_f32 * v2d).sum(1),
        "mul_sum_int8": lambda: (signs[:full] * v2d).sum(1),
    }
    forms_ms = {name: time_ms(torch, fn, 10, flush) for name, fn in forms.items()}
    plain_ms = forms_ms["mul_sum_f32"]
    del signs_f32, v2d
    nbytes = 4 * R50_D + k * m + 4 * k  # the replica, the int8 signs, the sketch
    sketch_bound, bound_by = bound_ms(nbytes, 2 * k * m)
    # The prefetch pipeline, traced, under a compute stand-in of the off
    # legs' median round.
    pipe = leg("prefetch", {"trace": True}, compute_s=off_ms / 1e3, overlap_prefetch=True)
    # Every round, the cold first one too, as wire_snapshot counts them.
    recs = [r for r in pipe.pop("records") if r.get("prefetched") is not None]
    wire_s = sum(r["stages"].get("wire", 0.0) for r in recs)
    wait_s = sum(r["stages"].get("join_wait", 0.0) for r in recs)
    span_hidden = max(1.0 - wait_s / wire_s, 0.0) if wire_s else 0.0
    ovs = pipe.pop("overlap")
    self_hidden = max(1.0 - sum(o["join_wait_s"] for o in ovs) / sum(o["fetch_s"] for o in ovs),
                      0.0)
    if abs(span_hidden - self_hidden) >= 0.10 or not any(r["prefetched"] for r in recs):
        raise AssertionError(f"obs_exchange: span-derived hidden fraction {span_hidden} against "
                             f"wire_snapshot's {self_hidden}")
    del base, signs
    torch.cuda.empty_cache()
    return {
        "d": R50_D, "order": list(OBS_ORDER), "warmups": OBS_WARMUPS, "rounds": OBS_ROUNDS,
        "legs": legs, "off_round_ms": off_ms, "on_round_ms": on_ms,
        "on_over_off": on_ms / off_ms, "frames_equal": True, "replicas_bit_equal": True,
        "stage_median_ms": stage_ms,
        "unstaged_ms": on_ms - sum(stage_ms.values()),
        "scrape": first["scrape"],
        "sketch": {"k": k, "ms": sketch_ms, "bound_ms": sketch_bound, "bound_by": bound_by,
                   "bytes": nbytes, "signs_bytes": k * m, "plain_ms": plain_ms,
                   "forms_ms": forms_ms,
                   "max_abs_err": float(err.max()), "bound_err_min": float(bound_err.min())},
        "prefetch": {**pipe, "compute_stand_in_ms": off_ms,
                     "stage_median_ms": medians([r for r in recs if r["step"] >= OBS_WARMUPS],
                                                OBS_PIPE_STAGES),
                     "span_hidden_frac": span_hidden, "wire_snapshot_hidden_frac": self_hidden,
                     "overlap": ovs},
    }


def cuda_event_ms(torch, fn, iters: int) -> float:
    """Mean time of ``fn`` between two CUDA events on the current stream
    (host work inside ``fn`` that waits on the card shows up too)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def train_bn(torch, merge, device, steps: int) -> dict:
    """ResNet-20 with BatchNorm (``norm_type="batch"``), the peers of
    ``examples/cifar10/nodes.yaml`` (8, ring, α 0.5), batch 64 a peer of the
    CIFAR-10 fixture, momentum SGD at 0.1, through the stacked step with
    model state: each step's losses, the running statistics after the last,
    B1's launches and the rate (the first step untimed)."""
    from dpwa_tpu_torch.config import load_config
    from dpwa_tpu_torch.data import device_batches, peer_batches
    from dpwa_tpu_torch.examples.cifar10 import load_cifar10
    from dpwa_tpu_torch.models import resnet
    from dpwa_tpu_torch.optim import sgd
    from dpwa_tpu_torch.parallel import stacked
    from dpwa_tpu_torch.train import init_params_per_peer, softmax_cross_entropy_with_integer_labels
    from dpwa_tpu_torch.utils import prng

    cfg = load_config(os.path.join(HERE, "examples/cifar10/nodes.yaml"))
    n = cfg.n_peers
    transport = stacked.StackedTransport(cfg, device=device)
    model = resnet.ResNet20(norm_type="batch").to(device)
    params = init_params_per_peer(lambda k: resnet.init(model, k, device), prng.key(0), n, device)
    stats = {k: v.expand(n, *v.shape).clone() for k, v in resnet.batch_stats(model, device).items()}
    opt = sgd(0.1, momentum=0.9)
    state = stacked.init_stacked_state(params, opt, transport, stats)

    def loss_fn(p, model_state, batch):
        logits, new = resnet.apply_batch_norm(model, p, model_state, batch[0])
        return softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean(), new

    step_fn = stacked.make_stacked_train_step(loss_fn, opt, transport, with_state=True)
    x_tr, y_tr, _, _ = load_cifar10(os.path.join(HERE, "data/cifar10_fixture"))
    batches = device_batches(peer_batches(x_tr, y_tr, n, 64, seed=cfg.protocol.seed), device)
    width = state.params.size + state.model_state.size
    merge.reset_launch_counts()  # count the main path's launches only
    state, losses, _ = step_fn(state, next(batches))
    step_losses = [losses.mean()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1, steps):
        state, losses, _ = step_fn(state, next(batches))
        step_losses.append(losses.mean())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"pair_merge_": merge.pair_merge_.launches,
                "gather_merge": merge.gather_merge.launches}
    moved = state.model_state.flat
    return {
        "steps": steps, "steps_per_sec": (steps - 1) / dt, "losses": torch.stack(step_losses).tolist(),
        "launches": launches, "row": [n, width], "params_per_peer": state.params.size,
        "stats_per_peer": state.model_state.size,
        "stats_finite": bool(torch.isfinite(moved).all()),
        "stats_moved": not torch.equal(moved, torch.cat(
            [v.reshape(n, -1) for k, v in sorted(stats.items(), key=lambda kv: kv[0].split("."))], 1)),
        "final_step": state.step,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--phases", default=",".join(ALL_PHASES),
        help="comma-separated subset of " + ",".join(ALL_PHASES + EXTRA_PHASES)
        + " (the last of them only when named)",
    )
    ap.add_argument(
        "--seed", type=int, default=0,
        help="the seed of view_tcp's replicas and schedule",
    )
    ap.add_argument(
        "--out", default=None,
        help="also write every JSON line to this file (the end of the output "
        "may be all a caller gets back)",
    )
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        OUT.append(open(args.out, "w"))
    from dpwa_tpu_torch.ops import _build, merge
    from dpwa_tpu_torch.ops import flash_attention as fa
    from dpwa_tpu_torch.ops import flash_ring as fr

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    name_limit = smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    emit({
        "phase": "device", "nvidia_smi": name_limit, "kind": kind,
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda,
    })

    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    ptxas = {}
    for log in logs.values():
        ptxas.update(ptxas_kernels(log))
    # The attention kernels must run their products on the tensor cores.
    sass = sass_counts(_build.library_path("flash_attention.cu"))
    for name in (FWD_KERNEL, *BWD_KERNELS[False], *BWD_KERNELS[True]):
        if not sass.get(name, {}).get("hmma_tf32"):
            raise AssertionError(f"{name}: no TF32 tensor-core instruction in its SASS ({sass.get(name)})")
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas, "sass": sass})

    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=device)
    results = {}
    for kind_name in ("b1", "b2"):
        if kind_name not in phases:
            continue
        t0 = time.perf_counter()
        res = kernel_checks(torch, merge, device, flush, kind_name)
        if kind_name == "b2":  # B2 over one row, as the TCP transport runs it
            res["tcp"] = tcp_merge_checks(torch, merge, device, flush)
        results[kind_name] = res
        emit({"phase": kind_name, "seconds": time.perf_counter() - t0, **res})
    if "codec_kernels" in phases:
        # The TCP codecs' kernels at ResNet-50's d: the int8 quantiser and
        # B2's int8-frame and support forms.
        t0 = time.perf_counter()
        results["codec_kernels"] = codec_kernel_checks(torch, merge, device, flush)
        emit({"phase": "codec_kernels", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **results["codec_kernels"]})
    if "fold_kernels" in phases:
        # B2's fold form at ResNet-50's d, and the fan-in round there (the
        # fold's main path: its launches counted from 0).
        t0 = time.perf_counter()
        results["fold_kernels"] = fold_kernel_checks(torch, merge, device, flush)
        emit({"phase": "fold_kernels", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **results["fold_kernels"]})
    if "b5" in phases:
        t0 = time.perf_counter()
        results["b5"] = flash_checks(torch, fa, device, flush, ptxas)
        emit({"phase": "b5", "seconds": time.perf_counter() - t0, **results["b5"]})
    for kind_name in ("b3", "b4"):
        if kind_name not in phases:
            continue
        t0 = time.perf_counter()
        results[kind_name] = ring_checks(torch, fr, device, flush, kind_name, ptxas)
        emit({"phase": kind_name, "seconds": time.perf_counter() - t0, **results[kind_name]})
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()

    if "card_tests" in phases:
        # The repository's card tests: each kernel against its plain version
        # in the row layouts the main path does not give it (packed rows,
        # column slices), the wrappers' argument checks, and 4-peer ResNet-8
        # steps on the card against the same steps on the CPU.
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
             "-p", "no:cacheprovider", "tests/test_torch_card.py"],
            cwd=HERE, capture_output=True, text=True, timeout=600,
        )
        summary = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
        emit({"phase": "card_tests", "seconds": time.perf_counter() - t0,
              "rc": out.returncode, "summary": summary})
        if out.returncode != 0 or "skipped" in summary or "passed" not in summary:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"card tests failed: {summary}")

    from dpwa_tpu_torch.examples import cifar10

    main_launches, rates = {}, {}
    train_tcp_rate = None  # train_tcp's steps/s, beside obs_tcp's
    for phase, extra, steps, kernel in (
        ("train", [], 20, "pair_merge_"),
        ("train_pull", ["--mode", "pull"], 5, "gather_merge"),
        # The main path again under torch.profiler: where the device time
        # of a step goes, and how much of the wall time the card idles.
        ("profile", ["--profile"], 11, "pair_merge_"),
    ):
        if phase not in phases:
            continue
        argv = [
            "--config", os.path.join(HERE, "examples/cifar10/nodes.yaml"),
            "--data-dir", os.path.join(HERE, "data/cifar10_fixture"),
            "--steps", str(steps), "--batch-size", "64", "--log-every", "5",
            *extra,
        ]
        torch.cuda.reset_peak_memory_stats(device)
        merge.reset_launch_counts()  # count the main path's launches only
        res = cifar10.main(argv)
        launches = {
            "pair_merge_": merge.pair_merge_.launches,
            "gather_merge": merge.gather_merge.launches,
        }
        losses = res["losses"]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase}: bad losses {losses}")
        if not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in res["accuracy"]):
            raise AssertionError(f"{phase}: bad accuracies {res['accuracy']}")
        if res["device"] != kind or res["final_step"] != steps:
            raise AssertionError(f"{phase}: ran on {res['device']} for {res['final_step']} steps")
        other = "gather_merge" if kernel == "pair_merge_" else "pair_merge_"
        if launches[kernel] != steps or launches[other] != 0:
            raise AssertionError(
                f"{phase}: {steps} steps launched {launches}, expected one "
                f"{kernel} per step"
            )
        main_launches[phase] = launches
        rates[phase] = res["steps_per_sec"]
        emit({
            "phase": phase, "steps": steps, "steps_per_sec": res["steps_per_sec"],
            "init_seconds": res["init_seconds"], "step0_loss": losses[0],
            "losses": losses, "mean_accuracy": sum(res["accuracy"]) / len(res["accuracy"]),
            "launches": launches, "payload_bytes": res["payload_bytes"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
            "profile": res["profile"],
        })

    from dpwa_tpu_torch.examples import mnist as mnist_example

    for phase, steps, profile in (
        ("train_mnist", MNIST_STEPS, False),
        # The MNIST path under torch.profiler: where a step's time goes.
        ("profile_mnist", 11, True),
    ):
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        merge.reset_launch_counts()  # count the main path's launches only
        res = mnist_example.main([
            "--steps", str(steps), "--log-every", "50", *(["--profile"] if profile else []),
        ])
        launches = {
            "pair_merge_": merge.pair_merge_.launches,
            "gather_merge": merge.gather_merge.launches,
        }
        losses = res["losses"]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase}: bad losses {losses}")
        if res["device"] != kind or res["final_step"] != steps or res["n_peers"] != MNIST_PEERS:
            raise AssertionError(f"{phase}: ran {res['n_peers']} peers on {res['device']} "
                                 f"for {res['final_step']} steps")
        if res["state"].params.size != MNIST_D or res["dataset"] != "digits":
            raise AssertionError(f"{phase}: {res['state'].params.size} parameters on {res['dataset']}")
        if launches != {"pair_merge_": steps, "gather_merge": 0}:
            raise AssertionError(f"{phase}: {steps} steps launched {launches}")
        mean_acc = sum(res["accuracy"]) / len(res["accuracy"])
        # The reference's own bar for SmallNet on the digits
        # (tests/test_train.py:71-92).
        if not profile and not mean_acc >= 0.9:
            raise AssertionError(f"{phase}: mean test accuracy {mean_acc} < 0.9")
        main_launches[phase] = launches
        emit({
            "phase": phase, "seconds": time.perf_counter() - t0, "steps": steps,
            "n_peers": MNIST_PEERS, "params_per_peer": MNIST_D, "dataset": res["dataset"],
            "nvidia_smi": name_limit, "steps_per_sec": res["steps_per_sec"],
            "init_seconds": res["init_seconds"], "step0_loss": losses[0], "last_loss": losses[-1],
            "mean_accuracy": mean_acc, "accuracy": res["accuracy"], "launches": launches,
            "payload_bytes": res["payload_bytes"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device), "profile": res["profile"],
        })

    if "resume_mnist" in phases:
        # A 14-step run saved at step 10, a second straight run, and a
        # resume from the step-10 checkpoint: all three must end in the same
        # state and stream position, bit for bit.
        t0 = time.perf_counter()
        root = os.path.join(HERE, "build", "resume_mnist")
        shutil.rmtree(root, ignore_errors=True)
        base = ["--steps", str(RESUME_STEPS), "--log-every", "100"]
        ck = os.path.join(root, "ck")
        merge.reset_launch_counts()  # count the main path's launches only
        full = mnist_example.main(base + ["--checkpoint", ck, "--save-every", str(RESUME_SAVE)])
        again = mnist_example.main(base + ["--checkpoint", os.path.join(root, "again"),
                                           "--save-every", str(RESUME_STEPS + 1)])
        resumed = mnist_example.main(base + ["--checkpoint", ck, "--resume"])
        launches = {"pair_merge_": merge.pair_merge_.launches,
                    "gather_merge": merge.gather_merge.launches}
        ckpt_bytes = sum(os.path.getsize(os.path.join(dirpath, f))
                         for dirpath, _, files in os.walk(root) for f in files
                         if os.path.join(dirpath, f).startswith(ck))
        straight_diff = run_differences(torch, full, again)
        resume_diff = run_differences(torch, full, resumed)
        want_launches = 2 * RESUME_STEPS + RESUME_STEPS - RESUME_SAVE
        phase = "resume_mnist"
        main_launches[phase] = launches
        emit({
            "phase": phase, "seconds": time.perf_counter() - t0, "steps": RESUME_STEPS,
            "save_every": RESUME_SAVE, "resumed_at": resumed["start_step"],
            "nvidia_smi": name_limit, "straight_runs_differ_in": straight_diff,
            "resume_differs_in": resume_diff, "save_seconds": full["save_seconds"],
            "restore_seconds": resumed["restore_seconds"], "checkpoint_bytes": ckpt_bytes,
            "launches": launches, "losses_full": full["losses"], "losses_resumed": resumed["losses"],
        })
        shutil.rmtree(root, ignore_errors=True)
        if straight_diff or resume_diff:
            raise AssertionError(f"{phase}: two straight runs differ in {straight_diff}, "
                                 f"the resumed run in {resume_diff}")
        if resumed["start_step"] != RESUME_SAVE or launches != {
                "pair_merge_": want_launches, "gather_merge": 0}:
            raise AssertionError(f"{phase}: resumed at {resumed['start_step']}, launched {launches}")

    if "train_bn" in phases:
        t0 = time.perf_counter()
        res = train_bn(torch, merge, device, BN_STEPS)
        if len(res["losses"]) != BN_STEPS or not all(math.isfinite(v) for v in res["losses"]):
            raise AssertionError(f"train_bn: bad losses {res['losses']}")
        if not (res["stats_finite"] and res["stats_moved"]) or res["final_step"] != BN_STEPS:
            raise AssertionError(f"train_bn: statistics finite {res['stats_finite']}, moved "
                                 f"{res['stats_moved']}, {res['final_step']} steps")
        if res["launches"] != {"pair_merge_": BN_STEPS, "gather_merge": 0} or res["row"][1] != BN_D:
            raise AssertionError(f"train_bn: {BN_STEPS} steps over {res['row']} launched {res['launches']}")
        main_launches["train_bn"] = res["launches"]
        emit({"phase": "train_bn", "seconds": time.perf_counter() - t0, "nvidia_smi": name_limit,
              "group_norm_train_steps_per_sec": rates.get("train"), **res})
        torch.cuda.empty_cache()

    if "train_tcp" in phases:
        # The launches are counted in each process (fresh counts there).
        t0 = time.perf_counter()
        res = train_tcp(kind)
        train_tcp_rate = [n["steps_per_sec"] for n in res["nodes"]]
        main_launches["train_tcp"] = {
            "pair_merge_": 0, "gather_merge": sum(n["b2_launches"] for n in res["nodes"])}
        emit({"phase": "train_tcp", "seconds": time.perf_counter() - t0, "nvidia_smi": name_limit,
              "steps": MNIST_STEPS, "nodes": res["nodes"],
              "mean_accuracy": sum(n["accuracy"] for n in res["nodes"]) / len(res["nodes"]),
              "steps_per_sec": [n["steps_per_sec"] for n in res["nodes"]],
              "trust_verdicts": [n["verdicts"] for n in res["nodes"]],
              "membership_events": [n["events"] for n in res["nodes"]]})

    if "codecs_tcp" in phases:
        # The launches are counted in each process (fresh counts there).
        t0 = time.perf_counter()
        res = codecs_tcp(kind)
        runs = [n for name in CODEC_RUNS for n in res[name]]
        main_launches["codecs_tcp"] = {
            "gather_merge": sum(n["b2_launches"] - n["int8_frame_launches"] - n["topk_launches"]
                                for n in runs),
            "int8_frame_merge": sum(n["int8_frame_launches"] for n in runs),
            "topk_merge": sum(n["topk_launches"] for n in runs),
            "quantize_sr": sum(n["quantize_launches"] for n in runs)}
        emit({"phase": "codecs_tcp", "seconds": time.perf_counter() - t0, "nvidia_smi": name_limit,
              "steps": MNIST_STEPS, **res})

    if "overlap_tcp" in phases:
        t0 = time.perf_counter()
        res = overlap_tcp(torch, merge, device, kind)
        main_launches["overlap_tcp"] = {"gather_merge": res["prefetch"]["b2_launches"]}
        emit({"phase": "overlap_tcp", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **res})
        torch.cuda.empty_cache()

    if "async_tcp" in phases:
        t0 = time.perf_counter()
        res = async_tcp(torch, merge, device, kind)
        main_launches["async_tcp"] = {
            **res["async"]["launches"],
            "fold_merge_mnist": sum(n["fold_launches"] for n in res["mnist"])}
        emit({"phase": "async_tcp", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **res})

    if "slowpeer_tcp" in phases:
        t0 = time.perf_counter()
        res = slowpeer_tcp(kind)
        main_launches["slowpeer_tcp"] = {
            "pair_merge_": 0, "gather_merge": sum(res["b2_launches"].values())}
        emit({"phase": "slowpeer_tcp", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **res})

    if "train_tcp_planes" in phases:
        t0 = time.perf_counter()
        res = train_tcp_planes(kind)
        emit({"phase": "train_tcp_planes", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, "steps": MNIST_STEPS, **res})

    if "trust_screen" in phases:
        t0 = time.perf_counter()
        flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=device)
        res = trust_screen(torch, device, flush)
        del flush
        torch.cuda.empty_cache()
        emit({"phase": "trust_screen", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **res})

    if "byzantine_tcp" in phases:
        t0 = time.perf_counter()
        res = byzantine_tcp(torch, kind, device)
        main_launches["byzantine_tcp"] = {
            "pair_merge_": 0, "gather_merge": sum(res["b2_launches"].values())}
        emit({"phase": "byzantine_tcp", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, "steps": BYZ_STEPS, **res})

    if "tcp_exchange" in phases:
        for wire in ("f32", "bf16"):
            t0 = time.perf_counter()
            res = tcp_exchange(torch, merge, device, wire)
            main_launches[f"tcp_exchange_{wire}"] = {
                "pair_merge_": 0, "gather_merge": res["b2_launches"]}
            results[f"tcp_exchange_{wire}"] = res
            emit({"phase": "tcp_exchange", "seconds": time.perf_counter() - t0,
                  "nvidia_smi": name_limit, **res})
            torch.cuda.empty_cache()

    if "view_tcp" in phases:
        # 16 nodes of this process under a partial view, on the reactor; the
        # launches counted from 0 in each of its three runs.
        t0 = time.perf_counter()
        res = view_tcp(torch, merge, device, args.seed)
        main_launches["view_tcp"] = {"pair_merge_": 0, "gather_merge": res["b2_launches"]["view"]}
        emit({"phase": "view_tcp", "seconds": time.perf_counter() - t0, "nvidia_smi": name_limit,
              **res})
        torch.cuda.empty_cache()

    if "reactor_tcp" in phases:
        # The launches are counted in each process (fresh counts there).
        t0 = time.perf_counter()
        res = reactor_tcp(torch, kind, device)
        main_launches["reactor_tcp"] = {
            "pair_merge_": 0,
            "gather_merge": sum(n["b2_launches"] for n in res["train"]["nodes"])
            + sum(res["byzantine"]["b2_launches"].values())}
        emit({"phase": "reactor_tcp", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **res})

    if "reactor_exchange" in phases:
        t0 = time.perf_counter()
        res = reactor_exchange(torch, merge, device)
        main_launches["reactor_exchange"] = {
            "pair_merge_": 0, "gather_merge": sum(leg["b2_launches"] for leg in res["legs"])}
        emit({"phase": "reactor_exchange", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **res})

    if "obs_tcp" in phases:
        # The launches are counted in each process (fresh counts there).
        t0 = time.perf_counter()
        res = obs_tcp(kind)
        main_launches["obs_tcp"] = {
            "pair_merge_": 0, "gather_merge": sum(n["b2_launches"] for n in res["nodes"])}
        emit({"phase": "obs_tcp", "seconds": time.perf_counter() - t0, "nvidia_smi": name_limit,
              "steps": MNIST_STEPS, "train_tcp_steps_per_sec": train_tcp_rate, **res})

    if "obs_exchange" in phases:
        t0 = time.perf_counter()
        flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=device)
        res = obs_exchange(torch, merge, device, flush)
        del flush
        main_launches["obs_exchange"] = {
            "pair_merge_": 0,
            "gather_merge": sum(leg["b2_launches"] for leg in res["legs"])
            + res["prefetch"]["b2_launches"]}
        emit({"phase": "obs_exchange", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **res})
        torch.cuda.empty_cache()

    if "hier_tcp" in phases:
        # The launches are counted in each process (fresh counts there).
        t0 = time.perf_counter()
        res = hier_tcp(kind)
        main_launches["hier_tcp"] = {
            "pair_merge_": 0, "gather_merge": sum(res["b2_launches"])}
        emit({"phase": "hier_tcp", "seconds": time.perf_counter() - t0, "nvidia_smi": name_limit,
              "steps": MNIST_STEPS, "train_tcp_steps_per_sec": train_tcp_rate, **res})

    if "hier_engine" in phases:
        t0 = time.perf_counter()
        res = hier_engine(torch, device)
        emit({"phase": "hier_engine", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **res})
        torch.cuda.empty_cache()

    if "wire_exchange" in phases:
        t0 = time.perf_counter()
        res = wire_exchange(torch, merge, device)
        totals = {}
        for leg in res["legs"].values():
            for key, n in leg["launches"].items():
                totals[key] = totals.get(key, 0) + n
        main_launches["wire_exchange"] = totals
        results["wire_exchange"] = res
        emit({"phase": "wire_exchange", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, "launches": totals, **res})

    if "rollback_tcp" in phases:
        t0 = time.perf_counter()
        res = rollback_tcp(kind)
        main_launches["rollback_tcp"] = {
            "pair_merge_": 0, "gather_merge": sum(n["b2_launches"] for n in res["nodes"])}
        emit({"phase": "rollback_tcp", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, "steps": MNIST_STEPS, "diverge_at": ROLLBACK_AT, **res})

    if "recover_tcp" in phases:
        t0 = time.perf_counter()
        res = recover_tcp(kind)
        main_launches["recover_tcp"] = {
            "pair_merge_": 0, "gather_merge": sum(res["b2_launches"].values())}
        emit({"phase": "recover_tcp", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **res})

    if "state_exchange" in phases:
        t0 = time.perf_counter()
        res = state_exchange(torch, device)
        torch.cuda.empty_cache()
        emit({"phase": "state_exchange", "seconds": time.perf_counter() - t0,
              "nvidia_smi": name_limit, **res})

    for phase, extra, kernel in (
        # The ResNet-20 path with partial participation and faults on the
        # int8 wire: the host's draws, the wire's fake quantisation, and the
        # wire form of B1 (pairwise) and of B2 (pull).
        ("train_draws", [], "pair_merge_"),
        ("train_draws_pull", ["--mode", "pull"], "gather_merge"),
    ):
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        steps = DRAWS["steps"]
        config = os.path.join(HERE, "examples/cifar10/nodes.yaml")
        argv = [
            "--config", config, "--data-dir", os.path.join(HERE, "data/cifar10_fixture"),
            "--steps", str(steps), "--batch-size", "64", "--log-every", "1",
            "--wire-dtype", "int8",
            "--fetch-probability", str(DRAWS["fetch_probability"]),
            "--drop-probability", str(DRAWS["drop_probability"]), *extra,
        ]
        merge.reset_launch_counts()  # count the main path's launches only
        res = cifar10.main(argv)
        launches = {
            "pair_merge_": merge.pair_merge_.launches,
            "gather_merge": merge.gather_merge.launches,
        }
        losses = res["losses"]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase}: bad losses {losses}")
        if res["device"] != kind or res["final_step"] != steps:
            raise AssertionError(f"{phase}: ran on {res['device']} for {res['final_step']} steps")
        other = "gather_merge" if kernel == "pair_merge_" else "pair_merge_"
        if launches[kernel] != steps or launches[other] != 0:
            raise AssertionError(f"{phase}: {steps} steps launched {launches}")
        # Each step's participation on the card against the draws on the host.
        from dpwa_tpu_torch.config import load_config
        from dpwa_tpu_torch.parallel import schedules
        from dpwa_tpu_torch.utils.launch import apply_overrides

        sched = schedules.build_schedule(apply_overrides(
            load_config(config), "int8", "pull" if extra else None,
            DRAWS["fetch_probability"], DRAWS["drop_probability"],
        ))
        want = [[sched.participates(step, i) for i in range(sched.n_peers)] for step in range(steps)]
        if res["participated"] != want:
            raise AssertionError(f"{phase}: participation {res['participated']} != host draws {want}")
        paired = sum(int(sched.partner(step, i) != i) for step in range(steps) for i in range(sched.n_peers))
        kept = sum(map(sum, want))
        if not 0 < kept < paired:
            raise AssertionError(f"{phase}: the draws kept {kept} of {paired} paired peers")
        main_launches[phase] = launches
        fq = {}
        if kernel == "pair_merge_":
            # The int8 wire's fake quantisation alone, at this path's layout
            # and (once) at the ImageNet path's, against the step.
            fq["fake_quant_ms"] = fake_quant_ms(torch, merge, resnet_shapes(False, device), N_PEERS, device, 10)
            fq["fake_quant_share_of_step"] = fq["fake_quant_ms"] * res["steps_per_sec"] / 1e3
            fq["fake_quant_ms_resnet50_32_peers"] = fake_quant_ms(
                torch, merge, resnet_shapes(True, device), R50_PEERS, device, 1)
        emit({
            "phase": phase, "seconds": time.perf_counter() - t0, "steps": steps,
            "wire": "int8", **{k: v for k, v in DRAWS.items() if k != "steps"},
            "steps_per_sec": res["steps_per_sec"], "step0_loss": losses[0], "losses": losses,
            "participated": [sum(r) for r in want], "paired": paired, "launches": launches,
            "payload_bytes": res["payload_bytes"], **fq,
        })
        torch.cuda.empty_cache()

    from dpwa_tpu_torch.examples import imagenet

    for phase, steps, profile in (
        ("train_imagenet", IMAGENET_STEPS, False),
        # The ImageNet path again under torch.profiler: where its device
        # time goes, and B1's time inside the step at 3.27 GB.
        ("profile_imagenet", 3, True),
    ):
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        merge.reset_launch_counts()  # count the main path's launches only
        res = imagenet.main([
            "--peers", str(R50_PEERS), "--steps", str(steps),
            "--batch-size", str(IMAGENET_BATCH), "--image-size", "224", "--log-every", "1",
            *(["--profile"] if profile else []),
        ])
        launches = {
            "pair_merge_": merge.pair_merge_.launches,
            "gather_merge": merge.gather_merge.launches,
        }
        torch.cuda.empty_cache()
        losses = res["losses"]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase}: bad losses {losses}")
        if res["device"] != kind or res["final_step"] != steps:
            raise AssertionError(f"{phase}: ran on {res['device']} for {res['final_step']} steps")
        if res["params_per_peer"] != R50_D or res["n_peers"] != R50_PEERS:
            raise AssertionError(f"{phase}: {res['n_peers']} peers of {res['params_per_peer']} parameters")
        if launches != {"pair_merge_": steps, "gather_merge": 0}:
            raise AssertionError(f"{phase}: {steps} steps launched {launches}")
        main_launches[phase] = launches
        emit({
            "phase": phase, "seconds": time.perf_counter() - t0, "steps": steps,
            "n_peers": R50_PEERS, "batch_per_peer": IMAGENET_BATCH, "image_size": 224,
            "params_per_peer": res["params_per_peer"], "nvidia_smi": name_limit,
            "steps_per_sec": res["steps_per_sec"], "images_per_sec": res["images_per_sec"],
            "init_seconds": res["init_seconds"], "step0_loss": losses[0], "losses": losses,
            "launches": launches, "payload_bytes": res["payload_bytes"],
            "peak_mem_bytes": res["peak_mem_bytes"], "profile": res["profile"],
            "b1_ms_in_step": res["profile"]["merge_ms_per_step"] if profile else None,
        })

    from dpwa_tpu_torch.examples import bert as bert_example

    for phase, steps, profile in (
        ("train_bert", BERT_STEPS, False),
        # The BERT path again under torch.profiler: where its device time
        # goes (GEMMs, AdamW, the exchange) and B1's time inside the step.
        ("profile_bert", 3, True),
    ):
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        merge.reset_launch_counts()  # count the main path's launches only
        res = bert_example.main([
            "--peers", str(BERT_PEERS), "--group-size", str(BERT_GROUP),
            "--inter-period", str(BERT_INTER), "--steps", str(steps),
            "--batch-size", str(BERT_BATCH), "--seq-len", str(BERT_T), "--lr", "1e-4",
            "--log-every", "1", *(["--profile"] if profile else []),
        ])
        launches = {
            "pair_merge_": merge.pair_merge_.launches,
            "gather_merge": merge.gather_merge.launches,
        }
        torch.cuda.empty_cache()
        losses = res["losses"]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase}: bad losses {losses}")
        # Every peer starts from the same init and the MLM head's logits
        # start near 0: the first loss is near ln(vocab).
        if not abs(losses[0] - math.log(BERT_VOCAB)) < 2.0:
            raise AssertionError(f"{phase}: step-0 loss {losses[0]}, ln V = {math.log(BERT_VOCAB)}")
        if res["device"] != kind or res["final_step"] != steps:
            raise AssertionError(f"{phase}: ran on {res['device']} for {res['final_step']} steps")
        if res["params_per_peer"] != BERT_D or res["n_peers"] != BERT_PEERS:
            raise AssertionError(f"{phase}: {res['n_peers']} peers of {res['params_per_peer']} parameters")
        if launches != {"pair_merge_": steps, "gather_merge": 0}:
            raise AssertionError(f"{phase}: {steps} steps launched {launches}")
        # Each step's pairing: a perfect matching, inside the groups on three
        # steps in four and across them on every fourth.
        groups = [i // BERT_GROUP for i in range(BERT_PEERS)]
        for step, partner in enumerate(res["partners"]):
            inter = step % BERT_INTER == BERT_INTER - 1
            if any(partner[partner[i]] != i or partner[i] == i
                   or (groups[partner[i]] != groups[i]) != inter for i in range(BERT_PEERS)):
                raise AssertionError(f"{phase}: step {step} pairs {partner}")
        main_launches[phase] = launches
        out = {
            "phase": phase, "seconds": time.perf_counter() - t0, "steps": steps,
            "n_peers": BERT_PEERS, "group_size": BERT_GROUP, "inter_period": BERT_INTER,
            "batch_per_peer": BERT_BATCH, "seq_len": BERT_T,
            "params_per_peer": res["params_per_peer"], "nvidia_smi": name_limit,
            "steps_per_sec": res["steps_per_sec"], "tokens_per_sec": res["tokens_per_sec"],
            "init_seconds": res["init_seconds"], "step0_loss": losses[0],
            "last_loss": losses[-1], "losses": losses, "launches": launches,
            "payload_bytes": res["payload_bytes"], "peak_mem_bytes": res["peak_mem_bytes"],
            "profile": res["profile"],
        }
        if profile:
            prof = res["profile"]
            busy = prof["device_busy_ms_per_step"]
            b1_bound = bound_ms(2 * BERT_PEERS * BERT_D * 4, 3 * BERT_PEERS * BERT_D)[0]
            out.update(
                busy_ms_per_step=busy, idle_share=prof["device_idle_share"],
                ops_per_step=prof["device_ops_per_step"],
                gemm_share_of_busy=prof["gemm_ms_per_step"] / busy,
                adamw_share_of_busy=prof["optimizer_ms_per_step"] / busy,
                b1_ms_in_step=prof["merge_ms_per_step"], b1_bound_ms=b1_bound,
            )
        emit(out)

    from dpwa_tpu_torch.examples import llama_lora

    for phase, steps, profile in (
        ("train_llama", LLAMA_STEPS, False),
        # The Llama path again under torch.profiler: where its device time
        # goes, and how much of the wall time the card idles.
        ("profile_llama", 4, True),
    ):
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        mcfg = llama_config()
        merge.reset_launch_counts()  # count the main path's launches only
        fa.reset_launch_counts()
        res = llama_lora.run(
            mcfg, peers=LLAMA_PEERS, steps=steps, batch_size=1, seq_len=LLAMA_T,
            lr=1e-3, log_every=1, profile=profile,
        )
        launches = {
            "pair_merge_": merge.pair_merge_.launches,
            "gather_merge": merge.gather_merge.launches,
            "flash_attn_fwd": fa.flash_attn_fwd.launches,
            "flash_attn_bwd": fa.flash_attn_bwd.launches,
        }
        torch.cuda.empty_cache()
        losses = res["losses"]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase}: bad losses {losses}")
        if res["device"] != kind or res["final_step"] != steps:
            raise AssertionError(f"{phase}: ran on {res['device']} for {res['final_step']} steps")
        want = {
            "pair_merge_": res["lora_column_ranges"] * steps, "gather_merge": 0,
            "flash_attn_fwd": LLAMA_LAYERS * steps, "flash_attn_bwd": LLAMA_LAYERS * steps,
        }
        if launches != want:
            raise AssertionError(f"{phase}: {steps} steps launched {launches}, expected {want}")
        if not res["frozen_unchanged"]:
            raise AssertionError(f"{phase}: a frozen base weight changed")
        main_launches[phase] = launches
        emit({
            "phase": phase, "seconds": time.perf_counter() - t0, "steps": steps,
            "n_peers": LLAMA_PEERS, "n_layers": LLAMA_LAYERS, "seq_len": LLAMA_T,
            "steps_per_sec": res["steps_per_sec"], "init_seconds": res["init_seconds"],
            "step0_loss": losses[0], "losses": losses,
            "launches": launches, "lora_column_ranges": res["lora_column_ranges"],
            "flat_layout": "LoRA leaves grouped in the leading columns",
            "payload_bytes": res["payload_bytes"],
            "model_bytes_per_peer": res["model_bytes_per_peer"],
            "frozen_unchanged": res["frozen_unchanged"],
            "peak_mem_bytes": res["peak_mem_bytes"],
            "init_peak_mem_bytes": res["init_peak_mem_bytes"], "profile": res["profile"],
        })

    from dpwa_tpu_torch.examples import longcontext

    for phase, (layout, strategy, steps, profile) in SP_PHASES.items():
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        mcfg = dataclasses.replace(
            llama_config(), sp_axis="sp", sp_layout=layout, sp_strategy=strategy
        )
        merge.reset_launch_counts()  # count the main path's launches only
        fa.reset_launch_counts()
        fr.reset_launch_counts()
        res = longcontext.run(
            mcfg, peers=SP_PEERS, sp=SP_SIZE, steps=steps, batch_size=1, seq_len=SP_T,
            lr=3e-3, log_every=1, profile=profile,
        )
        launches = {
            "pair_merge_": merge.pair_merge_.launches,
            "gather_merge": merge.gather_merge.launches,
            "ring_hop_fwd": fr.ring_hop_fwd.launches,
            "ring_hop_bwd_": fr.ring_hop_bwd_.launches,
            "flash_attn_fwd": fa.flash_attn_fwd.launches,
            "flash_attn_bwd": fa.flash_attn_bwd.launches,
        }
        torch.cuda.empty_cache()
        losses = res["losses"]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{phase}: bad losses {losses}")
        if res["device"] != kind or res["final_step"] != steps:
            raise AssertionError(f"{phase}: ran on {res['device']} for {res['final_step']} steps")
        hops = LLAMA_LAYERS * SP_SIZE * len(fr.hop_plan(layout, SP_T // SP_SIZE, True)[1]) * steps
        ring_path = strategy == "ring"
        want = {
            "pair_merge_": res["lora_column_ranges"] * steps, "gather_merge": 0,
            "ring_hop_fwd": hops if ring_path else 0, "ring_hop_bwd_": hops if ring_path else 0,
            "flash_attn_fwd": 0 if ring_path else LLAMA_LAYERS * steps,
            "flash_attn_bwd": 0 if ring_path else LLAMA_LAYERS * steps,
        }
        if launches != want:
            raise AssertionError(f"{phase}: {steps} steps launched {launches}, expected {want}")
        if not res["frozen_unchanged"]:
            raise AssertionError(f"{phase}: a frozen base weight changed")
        main_launches[phase] = launches
        emit({
            "phase": phase, "seconds": time.perf_counter() - t0, "steps": steps,
            "n_peers": SP_PEERS, "sp": SP_SIZE, "n_layers": LLAMA_LAYERS, "seq_len": SP_T,
            "sp_layout": layout, "sp_strategy": strategy,
            "steps_per_sec": res["steps_per_sec"], "init_seconds": res["init_seconds"],
            "step0_loss": losses[0], "losses": losses,
            "tokens_per_sec": res["steps_per_sec"] * SP_PEERS * SP_T,
            "launches": launches,
            "launches_per_step": {key: n / steps for key, n in launches.items()},
            "lora_column_ranges": res["lora_column_ranges"], "partners": res["partners"],
            "frozen_unchanged": res["frozen_unchanged"],
            "peak_mem_bytes": res["peak_mem_bytes"], "profile": res["profile"],
        })

    kernels = []
    for kind_name, name, phase, draws_phase, replaces in (
        ("b1", "pair_merge_", "train", "train_draws", "dpwa_tpu/ops/merge.py:342"),
        ("b2", "gather_merge", "train_pull", "train_draws_pull", "dpwa_tpu/ops/merge.py:103"),
    ):
        if kind_name not in results:
            continue
        timings = results[kind_name]["timings"]
        for form, at_main, launch_phase in (
            ("x", timings["main"], phase),
            # The wire form (the partner's row from the int8 wire's buffer).
            ("wire", timings["main_wire"], draws_phase),
        ):
            suffix = "" if form == "x" else "_wire"
            kernels.append({
                "name": name if form == "x" else f"{name}[wire]", "route": "cuda",
                "source": "dpwa_tpu_torch/ops/csrc/merge.cu", "replaces": replaces,
                "form": form, "wire": at_main["wire"],
                "launches": main_launches.get(launch_phase, {}).get(name),
                "launches_phase": launch_phase,
                "launches_imagenet": (main_launches.get("train_imagenet", {}).get(name)
                                      if form == "x" else None),
                "launches_llama": (main_launches.get("train_llama", {}).get(name)
                                   if form == "x" else None),
                "launches_bert": (main_launches.get("train_bert", {}).get(name)
                                  if form == "x" else None),
                "launches_mnist": (main_launches.get("train_mnist", {}).get(name)
                                   if form == "x" else None),
                "launches_batchnorm": (main_launches.get("train_bn", {}).get(name)
                                       if form == "x" else None),
                "max_abs_err": results[kind_name]["max_abs_err"],
                "ms": at_main["ms"], "plain_ms": at_main["plain_ms"],
                "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
                "library_ms": at_main["library_ms"], "at_shape": at_main["shape"],
                "at_resnet50": timings["resnet50" + suffix],
                "at_big": timings["big" + suffix],
                # B1 at the Llama path's LoRA column slice (1 launch per step there)
                "at_llama": timings.get("llama") if form == "x" else None,
                # B1 at the BERT path's whole-model rows (1 launch per step there)
                "at_bert": timings.get("bert") if form == "x" else None,
                # B1 at the MNIST path's rows, and at ResNet-20's parameters
                # with the running statistics after them (1 launch a step each)
                "at_mnist": timings.get("mnist") if form == "x" else None,
                "at_batchnorm": timings.get("bn") if form == "x" else None,
            })
            if kind_name == "b2" and form == "wire":
                # B2 over one row, the TCP transport's merge: its launches
                # in the two MNIST processes, with its checks and times at
                # their [1, 66410], and in the exchange bench, with those at
                # ResNet-50's [1, 25557032].
                tcp_rows = results[kind_name].get("tcp", {})
                kernels[-1].update({
                    "launches_tcp": main_launches.get("train_tcp", {}).get(name),
                    # The recovery phases' MNIST pairs: a rolled-back step,
                    # and a node killed and bootstrapped back.
                    "launches_rollback_tcp": main_launches.get("rollback_tcp", {}).get(name),
                    "launches_recover_tcp": main_launches.get("recover_tcp", {}).get(name),
                    # The three honest MNIST processes of the byzantine phase.
                    "launches_byzantine_tcp": main_launches.get("byzantine_tcp", {}).get(name),
                    # The four MNIST processes of the slow-peer phase.
                    "launches_slowpeer_tcp": main_launches.get("slowpeer_tcp", {}).get(name),
                    "at_tcp_mnist": tcp_rows.get("mnist"),
                    "launches_tcp_exchange": [
                        main_launches.get(f"tcp_exchange_{w}", {}).get(name) for w in ("f32", "bf16")],
                    # The 16 nodes under a partial view; the MNIST pair and
                    # the byzantine group on the reactor; the f32 exchange
                    # under each Rx server in turns.
                    "launches_view_tcp": main_launches.get("view_tcp", {}).get(name),
                    "launches_reactor_tcp": main_launches.get("reactor_tcp", {}).get(name),
                    "launches_reactor_exchange": main_launches.get("reactor_exchange", {}).get(name),
                    # The MNIST pair with the obs block on; the f32 exchange
                    # with it off and on in turns, and its prefetch leg.
                    "launches_obs_tcp": main_launches.get("obs_tcp", {}).get(name),
                    "launches_obs_exchange": main_launches.get("obs_exchange", {}).get(name),
                    # The eight processes of the two-island ring.
                    "launches_hier_tcp": main_launches.get("hier_tcp", {}).get(name),
                    "at_tcp": tcp_rows.get("resnet50"),
                })
    if "codec_kernels" in results:
        # The TCP codecs' kernels: their launches in the wire sweep (two
        # nodes in this process) and in the MNIST codec runs (per process).
        # B2's support form is off every path since the top-k form replaced
        # its route (0 launches); it stays in the line with its times.
        codec = results["codec_kernels"]
        for at, name, source, replaces in (
            (codec["quantize_sr"], "quantize_sr", "dpwa_tpu_torch/ops/csrc/quantize.cu",
             "dpwa_tpu/native/dpwa_native.cpp:56 (dpwa_quantize_sr; no Pallas kernel)"),
            (codec["b2_int8_frame"], "int8_frame_merge", "dpwa_tpu_torch/ops/csrc/merge.cu",
             "dpwa_tpu/ops/merge.py:103 (B2), dpwa_tpu/device/kernels.py:156 (build_int8)"),
            (codec["topk_merge"][TOPK_MERGE_CASES[0][0]], "topk_merge",
             "dpwa_tpu_torch/ops/csrc/merge.cu",
             "dpwa_tpu/ops/merge.py:103 (B2), dpwa_tpu/device/kernels.py:176 (build_topk), "
             ":216 (build_shard_topk)"),
            (codec["b2_support"], "support_merge_", "dpwa_tpu_torch/ops/csrc/merge.cu",
             "dpwa_tpu/ops/merge.py:103 (B2), dpwa_tpu/device/kernels.py:176 (build_topk)"),
        ):
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": main_launches.get("wire_exchange", {}).get(name),
                "launches_phase": "wire_exchange",
                "launches_codecs_tcp": main_launches.get("codecs_tcp", {}).get(name),
                "max_abs_err": at["max_abs_err"], "ms": at["ms"], "plain_ms": at["plain_ms"],
                "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
                "library_ms": at["library_ms"], "at_shape": at["shape"],
            })
        kernels[-2]["at_cases"] = codec["topk_merge"]
        for name in ("int8_frame_merge", "topk_merge", "quantize_sr"):
            if "wire_exchange" in main_launches and not main_launches["wire_exchange"].get(name):
                raise AssertionError(f"wire_exchange launched {name} no time")
    if "fold_kernels" in results:
        # B2's fold form: its launches on the fan-in round (counted from 0
        # just before it), in the async leg of async_tcp and in its MNIST
        # processes; its times at ResNet-50's d for each k.
        at = results["fold_kernels"]
        main = at[f"k{FOLD_KS[0]}"]
        launches = at["fan_in"]["launches"]["fold_merge"]
        if not launches:
            raise AssertionError("the fan-in round launched fold_merge no time")
        kernels.append({
            "name": "fold_merge", "route": "cuda", "source": "dpwa_tpu_torch/ops/csrc/merge.cu",
            "replaces": "dpwa_tpu/device/kernels.py::build_fold (:236, no Pallas kernel; "
                        "B2 dpwa_tpu/ops/merge.py:103 run k times)",
            "launches": launches, "launches_phase": "fold_kernels (the fan-in round)",
            "launches_async_tcp": main_launches.get("async_tcp", {}).get("fold_merge"),
            "launches_async_mnist": main_launches.get("async_tcp", {}).get("fold_merge_mnist"),
            "max_abs_err": max(at[f"k{k}"]["max_abs_err"] for k in FOLD_KS),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "at_shape": main["shape"],
            "k": main["k"], "sequential_b2_ms": main["sequential_b2_ms"],
            "at_k": {f"k{k}": {key: at[f"k{k}"][key] for key in (
                "ms", "plain_ms", "bound_ms", "sequential_b2_ms")} for k in FOLD_KS},
        })
    if "b5" in results:
        for kind_name, name in (("fwd", "flash_attn_fwd"), ("bwd", "flash_attn_bwd")):
            at_main = results["b5"]["timings"][kind_name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": "dpwa_tpu_torch/ops/csrc/flash_attention.cu",
                "replaces": "dpwa_tpu/ops/ulysses.py:119",
                "launches": main_launches.get("train_llama", {}).get(name),
                "launches_phase": "train_llama",
                "launches_sp_a2a": main_launches.get("train_sp_a2a", {}).get(name),
                "max_abs_err": results["b5"]["max_abs_err"],
                "ms": at_main["ms"], "plain_ms": at_main["plain_ms"],
                "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
                "bound_3xtf32_ms": at_main.get("bound_3xtf32_ms"),
                "library_ms": at_main["library_ms"],
                "at_shape": [*B5_CASES[0][1:4], 128], "kv_heads": B5_CASES[0][4],
                "ptxas": at_main["ptxas"],
            })
    for kind_name, name, replaces in (
        ("b3", "ring_hop_fwd", "dpwa_tpu/ops/flash_ring.py:71"),
        ("b4", "ring_hop_bwd_", "dpwa_tpu/ops/flash_ring.py:156"),
    ):
        if kind_name not in results:
            continue
        at_main = results[kind_name]["timings"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dpwa_tpu_torch/ops/csrc/flash_attention.cu", "replaces": replaces,
            "launches": main_launches.get("train_sp", {}).get(name),
            "launches_phase": "train_sp",
            "launches_zigzag": main_launches.get("train_sp_zigzag", {}).get(name),
            "max_abs_err": results[kind_name]["max_abs_err"],
            "ms": at_main["ms"], "plain_ms": at_main["plain_ms"],
            "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
            "bound_3xtf32_ms": at_main.get("bound_3xtf32_ms"),
            "library_ms": at_main["library_ms"], "library": at_main["library"],
            "at_shape": at_main["shape_q"], "kv_heads": at_main["kv_heads"],
            "ptxas": at_main["ptxas"],
            "timed": f"one layer's {SP_SIZE} hops of the contiguous causal ring",
        })
    emit({"kernels": kernels})
    print(name_limit, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
