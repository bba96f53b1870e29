"""Where a step's device time goes: ``torch.profiler`` around the timed
steps of an example, and a per-step breakdown of the trace.

The examples' ``--profile`` flag (and ``run(profile=True)``) wraps their
timed loop in :func:`tracer`; :func:`breakdown` reads the trace.  The
profiler slows the host, so a profiled rate is not the example's rate.
The stacked train step marks its three parts with :func:`span` (a
``record_function`` range, a few microseconds on the host when nothing
traces), and :func:`breakdown` reports the device time of the kernels each
part launched.
"""

from __future__ import annotations

# Kernel-name fragments of the port's own kernels, by family ("flash_attention"
# is B5 and the ring hops B3/B4 alike: they share their kernels).
KERNEL_FAMILIES = {
    "merge": ("merge_kernel",),
    "flash_attention": ("fwd_kernel", "delta_kernel", "dkdv_kernel", "dq_kernel"),
    # cuBLAS's and CUTLASS's matrix products (the float32 GEMMs, batched or not)
    "gemm": ("gemm", "Gemm", "xmma", "cutlass"),
}
# The stacked train step's parts (:func:`span` names): the per-peer
# gradients, the optimizer (packing the gradients and its update), and the
# updates' addition with the gossip round.
SPANS = ("step.grads", "step.optimizer", "step.exchange")


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name``."""
    from torch.profiler import record_function

    return record_function(name)


def tracer(device):
    """A ``torch.profiler.profile`` context over the CPU and, on a CUDA
    device, the card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def breakdown(prof, wall_s: float, steps: int, top: int = 8) -> dict:
    """Per-step device time from a profiler trace: busy time (the union of
    every kernel's and copy's interval on the card), the idle share of the
    wall window, the time of each kernel family, the device time of each
    part of the step (:data:`SPANS`, where the step marks them), and the
    kernels that take the most time."""
    from torch.autograd import DeviceType

    events = prof.events()
    # A part's device time: the kernels whose launching operation started
    # on the host inside the part's range, whichever thread launched them
    # (the autograd engine runs the backward in a thread of its own).
    windows = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.name in SPANS and e.device_type == DeviceType.CPU]
    spans, by_name, parts = [], {}, dict.fromkeys(SPANS, 0.0)
    for e in events:
        if e.device_type != DeviceType.CUDA:
            for lo, hi, name in windows if e.kernels else ():
                if lo <= e.time_range.start < hi:
                    parts[name] += sum(k.duration for k in e.kernels)
                    break
            continue
        if e.name in parts:  # a part's own range on the card's timeline
            continue
        spans.append((e.time_range.start, e.time_range.end))
        count, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, total + e.time_range.elapsed_us())
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    steps = max(steps, 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    out = {
        "steps": steps,
        "wall_ms_per_step": wall_s * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / (wall_s * 1e6) if wall_s > 0 else None,
        "device_ops_per_step": len(spans) / steps,
    }
    for family, fragments in KERNEL_FAMILIES.items():
        out[f"{family}_ms_per_step"] = sum(
            t for name, (_, t) in by_name.items()
            if any(f in name for f in fragments)
        ) / 1e3 / steps
    for name, us in parts.items():
        out[f"{name.split('.')[-1]}_ms_per_step"] = us / 1e3 / steps
    out["top"] = [
        {"name": name[:80], "per_step": count / steps, "ms_per_step": t / 1e3 / steps}
        for name, (count, t) in ranked[:top]
    ]
    return out
