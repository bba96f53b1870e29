"""Time variants of the attention kernels' source against the source in the
checkout, in turns, on one card.

    python3 -m dpwa_tpu_torch.ops.ab_kernels VARIANT.cu [VARIANT.cu ...]

from the root of a checkout (it imports ``chip_smoke``'s timing helpers).
Each ``VARIANT.cu`` is a whole copy of ``csrc/flash_attention.cu`` with one
change; it is built with the same ``nvcc`` flags into a library beside it.
The script times B5's forward at the Llama path's shape (``[4, 2048, 32,
128]``, kv 8, causal) and B3 over one layer's 4 hops of the long-context
ring (q ``[2, 8192, 32, 128]``, kv 8), on the checkout's library (A) and on
each variant (B, C, ...) in turns A B C … C B A, so that a drift of the
card's clock over the run cancels; says whether each variant's outputs are
bit-equal to A's; prints each variant's forward ptxas and SASS counts and,
last, one JSON object ``{label: {"b5": [ms, ...], "b3": [ms, ...]}}``.
"""

from __future__ import annotations

import ctypes
import json
import os
import string
import subprocess
import sys


def main(argv=None) -> int:
    variants = list(sys.argv[1:] if argv is None else argv)
    if not variants:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    import chip_smoke as cs
    from dpwa_tpu_torch.ops import _build
    from dpwa_tpu_torch.ops import flash_attention as fa
    from dpwa_tpu_torch.ops import flash_ring as fr

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.smi("name,power.limit"), flush=True)
    _build.build()
    libs = {"A": fa._lib()}
    labels = string.ascii_uppercase[1:1 + len(variants)]
    procs = []
    for label, src in zip(labels, variants):
        out = os.path.splitext(os.path.abspath(src))[0] + ".so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out, src]
        procs.append((label, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    real_load = _build.load
    try:
        for label, out, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on variant {label}:\n{log}")
            fwd = lambda d: {k: v for k, v in d.items() if k.startswith("fwd")}
            print(label, fwd(cs.ptxas_kernels(log)), fwd(cs.sass_counts(out)), flush=True)
            _build.load = lambda source, out=out: ctypes.CDLL(out)
            libs[label] = fa._lib.__wrapped__()  # the same argument types, this library
    finally:
        _build.load = real_load

    gen = torch.Generator(device=dev).manual_seed(5)
    q5 = torch.randn(4, 2048, 32, 128, device=dev, generator=gen)
    k5, v5 = (torch.randn(4, 2048, 8, 128, device=dev, generator=gen) for _ in range(2))
    q3 = torch.randn(2, 8192, 32, 128, device=dev, generator=gen)
    k3, v3 = (torch.randn(2, 8192, 8, 128, device=dev, generator=gen) for _ in range(2))
    hops = [fr.hop_cases(4, hop, "causal") for hop in range(4)]
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)
    b5 = lambda: fa.flash_attn_fwd(q5, k5, v5, causal=True)
    b3 = lambda: [fr.ring_hop_fwd(q3, k3, v3, sp=4, hop=i, cases=c) for i, c in enumerate(hops)]
    order = ["A", *labels]
    outs, res = {}, {label: {"b5": [], "b3": []} for label in order}
    real_lib = fa._lib
    try:
        for label in order + order[::-1]:
            fa._lib = lambda lib=libs[label]: lib
            res[label]["b5"].append(cs.time_ms(torch, b5, 20, flush))
            res[label]["b3"].append(cs.time_ms(torch, b3, 5, flush))
            if label not in outs:
                outs[label] = (b5(), b3()[1])
    finally:
        fa._lib = real_lib
    for label in labels:
        same5 = all(torch.equal(x, y) for x, y in zip(outs[label][0], outs["A"][0]))
        same3 = all(torch.equal(x, y) for x, y in zip(outs[label][1], outs["A"][1]))
        print(label, "bit-equal to A: b5", same5, "b3", same3, flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
