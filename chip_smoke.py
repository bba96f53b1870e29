#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``dpwa_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``dpwa_tpu_torch/ops/csrc`` (set-up
time), holds each kernel bit for bit against its plain PyTorch version on a
CPU copy of the same inputs at the main path's shapes, times each on the
card, runs the card tests, then drives the main path —
``dpwa_tpu_torch.examples.cifar10``: 8 peers, ResNet-20 at full width, ring
gossip on the CIFAR-10 fixture — pairwise (B1), in pull mode (B2) and once
more under the profiler, and checks that every exchange went through the
kernels.  One JSON line per
phase; the kernel table and the card's name and power limit come on the
lines before the last, and the last line is the result.  Any failed phase
exits nonzero without a result line, as does a machine without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
MAIN_D = 272474  # ResNet-20's parameters per peer: the main path's row
BIG_D = 24 * 2**20  # bench.py's default exchange size
N_PEERS = 8
ALL_PHASES = ("b1", "b2", "card_tests", "train", "train_pull", "profile")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    flat parameter buffer's layout, which the main path gives the kernels.
    The other row layouts the kernels take are in tests/test_torch_card.py."""
    n, d = cpu.shape
    buf = torch.zeros(n, -(-d // 32) * 32, dtype=torch.float32, device=device)
    view = buf[:, :d]
    view.copy_(cpu)
    return view


def kernel_checks(torch, merge, device, flush, kind: str) -> dict:
    """B1 (kind "b1") or B2 (kind "b2"): bit-equality against the plain
    version on CPU copies, then times at both sizes."""
    import numpy as np

    from dpwa_tpu_torch.parallel import schedules

    n = N_PEERS
    rng = np.random.default_rng(1234)
    if kind == "b1":
        maps = {
            "ring_even": schedules._ring_even(n),
            "ring_odd": schedules._ring_odd(n),
            "padded": np.array([1, 0, 2, 3, 5, 4, 6, 7]),
        }
    else:
        maps = {
            "pull_plus": schedules._ring_pull(n, 0),
            "pull_minus": schedules._ring_pull(n, 1),
        }
    alphas = {
        "0.5": np.full(n, 0.5, np.float32),
        "random": rng.uniform(0.0, 1.0, n).astype(np.float32),
    }
    cases = []
    for d in (MAIN_D, BIG_D):
        for map_name, perm in maps.items():
            for a_name, a_np in alphas.items():
                for wire in (False, True) if a_name == "random" else (False,):
                    cases.append((d, map_name, perm, a_name, a_np, wire))
    max_err, n_checked = 0.0, 0
    gen = torch.Generator().manual_seed(7)
    base = {d: torch.randn(n, d, generator=gen) for d in (MAIN_D, BIG_D)}
    for d, map_name, perm, a_name, a_np, wire in cases:
        x_cpu = base[d].clone()
        alpha = torch.from_numpy(a_np)
        x = padded_rows(torch, x_cpu, device)
        if kind == "b1":
            left, right = merge.involution_pairs(perm, pad_to=n // 2 if map_name == "padded" else None)
            left_t, right_t = torch.from_numpy(left), torch.from_numpy(right)
            merge.pair_merge_(
                x, left_t.to(device), right_t.to(device), alpha.to(device),
                wire_bf16=wire,
            )
            want = merge.torch_pair_merge_(x_cpu, left_t, right_t, alpha, wire_bf16=wire)
            got = x
        else:
            partner = torch.from_numpy(perm.astype(np.int32))
            got = merge.gather_merge(
                x, partner.to(device), alpha.to(device), wire_bf16=wire
            )
            want = merge.torch_pairwise_merge(x_cpu, partner, alpha, wire_bf16=wire)
        torch.cuda.synchronize()
        got = got.cpu()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(
                f"{kind} differs from its plain version: d={d} map={map_name} "
                f"alpha={a_name} bf16_wire={wire} "
                f"max_abs_err={err}"
            )
        max_err = max(max_err, err)
        n_checked += 1
    del base

    timings = {}
    map_name = next(iter(maps))
    perm = maps[map_name]
    a_np = alphas["random"]
    for d in (MAIN_D, BIG_D):
        gen = torch.Generator().manual_seed(11)
        x = padded_rows(torch, torch.randn(n, d, generator=gen), device)
        alpha = torch.from_numpy(a_np).to(device)
        partner64 = torch.from_numpy(perm.astype(np.int64)).to(device)
        y = x[partner64]  # pre-gathered rows for the library yardstick
        lib_out = torch.empty_like(y)
        if kind == "b1":
            left, right = (torch.from_numpy(v).to(device) for v in merge.involution_pairs(perm))
            rows = 2 * int((left != right).sum())
            kernel = lambda: merge.pair_merge_(x, left, right, alpha)
            plain = lambda: merge.torch_pair_merge_(x, left, right, alpha)
            n_bytes = 2 * rows * d * 4
            flops = 3 * rows * d
        else:
            partner = partner64.to(torch.int32)
            out = merge.gather_merge(x, partner, alpha)
            kernel = lambda: merge.gather_merge(x, partner, alpha, out=out)
            plain = lambda: merge.torch_pairwise_merge(x, partner, alpha)
            n_bytes = 2 * n * d * 4  # x read once, out written once
            flops = 3 * n * d
        library = lambda: torch.lerp(x, y, alpha[:, None], out=lib_out)
        iters = 30 if d == MAIN_D else 10
        ms = time_ms(torch, kernel, iters, flush)
        plain_ms = time_ms(torch, plain, iters, flush)
        library_ms = time_ms(torch, library, iters, flush)
        b_ms, b_by = bound_ms(n_bytes, flops)
        timings[d] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "gb_per_s": n_bytes / (ms * 1e-3) / 1e9,
        }
        del x, y, lib_out
    torch.cuda.synchronize()
    return {"cases": n_checked, "max_abs_err": max_err, "timings": timings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--phases", default=",".join(ALL_PHASES),
        help="comma-separated subset of " + ",".join(ALL_PHASES),
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
    from dpwa_tpu_torch.ops import _build, merge

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
    ptxas = [
        line.strip() for log in logs.values() for line in log.splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
    ]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=device)
    results = {}
    for kind_name in ("b1", "b2"):
        if kind_name not in phases:
            continue
        t0 = time.perf_counter()
        res = kernel_checks(torch, merge, device, flush, kind_name)
        results[kind_name] = res
        emit({"phase": kind_name, "seconds": time.perf_counter() - t0, **res})
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

    main_launches = {}
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
        emit({
            "phase": phase, "steps": steps, "steps_per_sec": res["steps_per_sec"],
            "losses": losses, "mean_accuracy": sum(res["accuracy"]) / len(res["accuracy"]),
            "launches": launches, "payload_bytes": res["payload_bytes"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
            "profile": res["profile"],
        })

    kernels = []
    for kind_name, name, phase, replaces in (
        ("b1", "pair_merge_", "train", "dpwa_tpu/ops/merge.py:342"),
        ("b2", "gather_merge", "train_pull", "dpwa_tpu/ops/merge.py:103"),
    ):
        if kind_name not in results:
            continue
        at_main = results[kind_name]["timings"][MAIN_D]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dpwa_tpu_torch/ops/csrc/merge.cu", "replaces": replaces,
            "launches": main_launches.get(phase, {}).get(name),
            "launches_phase": phase,
            "max_abs_err": results[kind_name]["max_abs_err"],
            "ms": at_main["ms"], "plain_ms": at_main["plain_ms"],
            "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
            "library_ms": at_main["library_ms"], "at_shape": [N_PEERS, MAIN_D],
        })
    emit({"kernels": kernels})
    print(name_limit, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
