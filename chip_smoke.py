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
  launch over ``[1, 66410]``; and the TCP exchange itself as ``bench.py``
  times it (2 nodes in one process, lock-step) with device-resident
  replicas of ResNet-50's 25,557,032 parameters on the f32 and bf16 wires;
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
    "train_mnist", "profile_mnist", "resume_mnist", "train_bn", "train_tcp", "tcp_exchange",
    "train_draws", "train_draws_pull", "train_imagenet", "profile_imagenet",
    "train_bert", "profile_bert", "train_llama", "profile_llama", "train_sp",
    "train_sp_zigzag", "train_sp_a2a", "profile_sp",
)
# The MNIST path (BASELINE config 1, stacked): 2 peers of SmallNet on the
# digits, 66,410 parameters a peer; the resume check's run and save step.
MNIST_D, MNIST_PEERS, MNIST_STEPS = 66410, 2, 300
RESUME_STEPS, RESUME_SAVE = 14, 10
# The TCP path (BASELINE config 1 as the reference deploys it): two OS
# processes of the MNIST example, one per node of examples/mnist/nodes.yaml,
# on the one card; the exchange bench at ResNet-50's vector (bench.py's TCP
# leg: 3 warm-up rounds, then 3 passes of 10, median of the pass medians).
TCP_TIMEOUT_S = 420
TCP_WARMUPS, TCP_PASSES, TCP_ITERS = 3, 3, 10
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
    rows, at ``[8, 24·2^20]`` and at the ImageNet path's ``[32, 25557032]``
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


def train_tcp(kind: str) -> dict:
    """Two OS processes of ``dpwa_tpu_torch.examples.mnist --transport tcp``,
    node0 and node1 of a copy of ``examples/mnist/nodes.yaml`` on two free
    ports, each with its replica on the card, free-running 300 steps as the
    reference's ``run_tcp.sh`` runs them; each process's summary line."""
    workdir = os.path.join(HERE, "build", "train_tcp")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(HERE, "examples/mnist/nodes.yaml")) as f:
        text = f.read()
    for old, new in zip(("port: 45000", "port: 45001"), free_ports(2)):
        if old not in text:
            raise AssertionError(f"examples/mnist/nodes.yaml has no {old!r}")
        text = text.replace(old, f"port: {new}")
    config = os.path.join(workdir, "nodes.yaml")
    with open(config, "w") as f:
        f.write(text)
    procs = []
    try:
        for i in range(MNIST_PEERS):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dpwa_tpu_torch.examples.mnist", "--transport", "tcp",
                 "--name", f"node{i}", "--config", config, "--steps", str(MNIST_STEPS),
                 "--batch-size", "32"],
                cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        outs = [p.communicate(timeout=TCP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    nodes = []
    for i, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        lines = stdout.strip().splitlines()
        if p.returncode != 0 or not lines:
            print(stdout[-3000:], stderr[-3000:], file=sys.stderr)
            raise AssertionError(f"train_tcp: node{i} exited {p.returncode}")
        res = json.loads(lines[-1])
        if res["device"] != kind or res["steps"] != MNIST_STEPS:
            raise AssertionError(f"train_tcp: node{i} ran on {res['device']} for {res['steps']} steps")
        if not res["accuracy"] >= 0.9:
            raise AssertionError(f"train_tcp: node{i} test accuracy {res['accuracy']} < 0.9")
        if res["merged_rounds"] < 1 or res["b2_launches"] != res["merged_rounds"]:
            raise AssertionError(
                f"train_tcp: node{i} merged {res['merged_rounds']} rounds with "
                f"{res['b2_launches']} B2 launches")
        nodes.append(res)
    shutil.rmtree(workdir, ignore_errors=True)
    return {"nodes": nodes}


def tcp_exchange(torch, merge, device, wire: str) -> dict:
    """``bench.py``'s TCP leg on the card: two nodes in this process on
    port 0, each with a device-resident replica of ResNet-50's d; 3 warm-up
    rounds, then 3 passes of 10 lock-step rounds (both publish, then both
    exchange on their own threads); a round's clock starts after the
    publishes, as bench's, and stops when both merges are done on the card;
    GB/s per peer as bench counts it (2·d·4 bytes a round) from the median
    of the pass medians.  Each exchange republishes its node's published
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
                            timeout_ms=10000, wire_dtype=wire)
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
            return results, elapsed

        for w in range(TCP_WARMUPS):
            one_round(w)
        medians = []
        for rep in range(TCP_PASSES):
            durations = []
            for it in range(TCP_ITERS):
                last, elapsed = one_round(TCP_WARMUPS + rep * TCP_ITERS + it)
                durations.append(elapsed)
            medians.append(float(np.median(durations)))
        rounds = TCP_WARMUPS + TCP_PASSES * TCP_ITERS
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
            "wire": wire, "d": R50_D, "frame_bytes": R50_D * (2 if wire == "bf16" else 4),
            "gbps": 2 * R50_D * 4 / median_s / 1e9,
            "rep_gbps": [2 * R50_D * 4 / m / 1e9 for m in medians],
            "round_ms": median_s * 1e3, "pass_median_ms": [m * 1e3 for m in medians],
            "warmups": TCP_WARMUPS, "passes": TCP_PASSES, "iters": TCP_ITERS,
            "b2_launches": launches, "max_abs_err": err, "alpha": last[0][1],
            "readback_ms": readback, "landing_ms": landing, "b2_ms": b2,
            "frame_pinned": host.is_pinned(),
            "handoff": stats, "ring": nodes[0].ring.stats(),
            "outcomes": [t.stats["outcomes"] for t in nodes],
        }
    finally:
        for t in nodes:
            t.close()


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
        help="comma-separated subset of " + ",".join(ALL_PHASES),
    )
    ap.add_argument(
        "--out", default=None,
        help="also write every JSON line to this file (the end of the output "
        "may be all a caller gets back)",
    )
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
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
        main_launches["train_tcp"] = {
            "pair_merge_": 0, "gather_merge": sum(n["b2_launches"] for n in res["nodes"])}
        emit({"phase": "train_tcp", "seconds": time.perf_counter() - t0, "nvidia_smi": name_limit,
              "steps": MNIST_STEPS, "nodes": res["nodes"],
              "mean_accuracy": sum(n["accuracy"] for n in res["nodes"]) / len(res["nodes"])})

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
                    "at_tcp_mnist": tcp_rows.get("mnist"),
                    "launches_tcp_exchange": [
                        main_launches.get(f"tcp_exchange_{w}", {}).get(name) for w in ("f32", "bf16")],
                    "at_tcp": tcp_rows.get("resnet50"),
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
