#!/usr/bin/env python
"""The reference's PyTorch usage, on the card: a torch model and the Dpwa
adapter (the port of ``examples/mnist_torch/main.py``; only the import of
the adapter changes, and the model lives on the card).

    forward / loss.backward() / optimizer.step()
    adapter.update(loss)        # publish, pick a peer, fetch, merge in place

Launch one process per YAML node::

    python -m dpwa_tpu_torch.examples.mnist_torch --name node0 &
    python -m dpwa_tpu_torch.examples.mnist_torch --name node1 &

The model is built on the CPU from ``torch.manual_seed(me)``, as the
reference's, then moved to the card (``--device cpu`` keeps it there).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[2]


def main(argv=None) -> dict:
    """Train this node and print its test accuracy; returns it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--name", required=True)
    ap.add_argument("--config", default=str(REPO / "examples/mnist/nodes.yaml"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' on purpose)")
    args = ap.parse_args(argv)

    # The one changed import against the reference's script:
    from dpwa_tpu_torch.adapters.tcp_adapter import DpwaPyTorchAdapter
    from dpwa_tpu_torch.config import load_config
    from dpwa_tpu_torch.data import load_mnist_or_digits, peer_split
    from dpwa_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    me = cfg.node_index(args.name)
    x_tr, y_tr, x_te, y_te, dataset = load_mnist_or_digits()
    xs, ys = peer_split(x_tr, y_tr, cfg.n_peers, seed=cfg.protocol.seed)
    x_my = torch.from_numpy(xs[me]).permute(0, 3, 1, 2).to(device)  # NCHW
    y_my = torch.from_numpy(ys[me]).long().to(device)
    side = x_tr.shape[1]

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(1, 16, 3, padding=1)
            self.fc1 = nn.Linear(16 * side * side, 64)
            self.fc2 = nn.Linear(64, 10)

        def forward(self, x):
            x = F.relu(self.conv(x))
            x = x.flatten(1)
            return self.fc2(F.relu(self.fc1(x)))

    torch.manual_seed(me)
    model = Net().to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    adapter = DpwaPyTorchAdapter(model, args.name, cfg)

    rng = np.random.default_rng(1000 + me)
    losses = []
    try:
        for step in range(args.steps):
            idx = torch.from_numpy(rng.integers(0, len(xs[me]), args.batch_size)).to(device)
            xb, yb = x_my[idx], y_my[idx]
            optimizer.zero_grad()
            loss = F.cross_entropy(model(xb), yb)
            loss.backward()
            optimizer.step()
            losses.append(loss.item())
            adapter.update(losses[-1])  # the reference's per-step call
            if step % 50 == 0:
                print(
                    f"[{args.name}] step {step} loss {losses[-1]:.4f} "
                    f"alpha {adapter.last_alpha:.2f} peer {adapter.last_partner}",
                    flush=True,
                )
        with torch.no_grad():
            x_all = torch.from_numpy(x_te).permute(0, 3, 1, 2).to(device)
            acc = float((model(x_all).argmax(1).cpu().numpy() == y_te).mean())
        print(f"[{args.name}] {dataset} test accuracy: {acc:.4f}")
    finally:
        adapter.close()
    return {"node": args.name, "losses": losses, "accuracy": acc}


if __name__ == "__main__":
    main()
