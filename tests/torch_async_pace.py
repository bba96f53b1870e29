"""Async rounds with one node paced faster, four OS processes on the CPU:
an all-reference group against a ref/port mixed one, their stale drops side
by side.

Each process is a node of a 4-node ring with ``protocol.async_rounds`` on
(the reference's defaults: ``max_staleness`` 4), its replica a seeded
vector of ``D`` floats nudged each step, exchanged through its package's
``DpwaTcpAdapter``; node0 sleeps ``FAST_S`` a step and the others
``SLOW_S``, so node0's clock runs ahead and the frames it fetches lag
behind it.  The nodes start together and serve on until every node is done
(file barriers), so no start or end reads as a dead peer.  Each node
prints its steps/s and its async engine's merges, stale, duplicate and
shed drops.

Run it from the repository root::

    JAX_PLATFORMS=cpu python tests/torch_async_pace.py

It prints one JSON line per group.  The counts depend on the host's
timing, so they are compared by kind (which nodes drop most), not for
equality.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
D, STEPS, FAST_S, SLOW_S = 4096, 120, 0.004, 0.012
GROUPS = {"all_reference": ("ref", "ref", "ref", "ref"), "mixed": ("port", "ref", "port", "ref")}


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _config(workdir: Path, n: int) -> Path:
    nodes = "".join(f"  - {{name: node{i}, host: 127.0.0.1, port: {p}}}\n"
                    for i, p in enumerate(_free_ports(n)))
    path = workdir / "nodes.yaml"
    path.write_text(f"nodes:\n{nodes}protocol:\n  schedule: ring\n  timeout_ms: 500\n"
                    "  seed: 0\n  async_rounds: {enabled: true}\n"
                    "interpolation:\n  type: constant\n  factor: 0.5\n")
    return path


def _barrier(directory: Path, phase: str, name: str, names, timeout_s: float = 120.0) -> None:
    (directory / f"{phase}.{name}").touch()
    deadline = time.monotonic() + timeout_s
    while not all((directory / f"{phase}.{n}").exists() for n in names):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{name}: barrier {phase}")
        time.sleep(0.02)


def worker(kind: str, name: str, config: str, barrier: str) -> None:
    """One node: ``STEPS`` steps of nudge-and-exchange at its pace."""
    import numpy as np

    names = [f"node{i}" for i in range(4)]
    me = names.index(name)
    pace = FAST_S if me == 0 else SLOW_S
    vec = np.random.default_rng(me).standard_normal(D).astype(np.float32)
    if kind == "ref":
        from dpwa_tpu.adapters.tcp_adapter import DpwaTcpAdapter as RefAdapter
        from dpwa_tpu.config import load_config as ref_load

        adapter = RefAdapter({"w": vec}, name, ref_load(config))
        as_params = lambda v: {"w": v}  # noqa: E731
        as_vec = lambda p: np.asarray(p["w"], np.float32)  # noqa: E731
    else:
        import torch

        from dpwa_tpu_torch.adapters.tcp_adapter import DpwaTcpAdapter
        from dpwa_tpu_torch.config import load_config

        adapter = DpwaTcpAdapter({"w": torch.from_numpy(vec)}, name, load_config(config),
                                 device="cpu")
        as_params = lambda v: {"w": torch.from_numpy(v)}  # noqa: E731
        as_vec = lambda p: np.asarray(p["w"], np.float32)  # noqa: E731
    try:
        _barrier(Path(barrier), "start", name, names)
        t0 = time.monotonic()
        for step in range(STEPS):
            vec = (vec * np.float32(0.999)).astype(np.float32)
            vec = as_vec(adapter.update(0.5, as_params(vec))).copy()
            time.sleep(pace)
        rate = STEPS / (time.monotonic() - t0)
        snap = adapter.transport.async_engine.snapshot()
        _barrier(Path(barrier), "done", name, names)
    finally:
        adapter.close()
    print(json.dumps({"node": name, "kind": kind, "pace_s": pace, "steps_per_sec": rate,
                      **{k: snap[k] for k in ("rounds", "merges", "stale_drops", "dup_drops",
                                              "shed")}}))


def run_group(kinds) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        config = _config(workdir, len(kinds))
        (workdir / "barrier").mkdir()
        env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(REPO))
        procs = [subprocess.Popen(
            [sys.executable, __file__, "worker", kind, f"node{i}", str(config),
             str(workdir / "barrier")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i, kind in enumerate(kinds)]
        outs = [p.communicate(timeout=600) for p in procs]
    rows = []
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"a node exited {p.returncode}: {err[-2000:]}")
        rows.append(json.loads(out.strip().splitlines()[-1]))
    return rows


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(*sys.argv[2:6])
    else:
        for group, kinds in GROUPS.items():
            print(json.dumps({"group": group, "nodes": run_group(kinds)}), flush=True)
