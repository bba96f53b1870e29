"""Transport selection for the examples (the port of
:mod:`dpwa_tpu.utils.launch`).

``stacked``: every peer on ONE device as a stacked leading axis.  ``tcp``:
this process is one node of the YAML config (``--name``), gossiping with
the others over TCP (:class:`~dpwa_tpu_torch.parallel.tcp.TcpTransport`);
its training loop is the example's own (the MNIST example's, with
:class:`~dpwa_tpu_torch.adapters.tcp_adapter.DpwaTcpAdapter`).  ``ici``
(one device per peer) raises until its port lands.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import NamedTuple, Optional


class TransportBundle(NamedTuple):
    transport: object
    init_state: object  # (stacked_params, opt, transport, ...) -> state
    make_step: object  # (loss_fn, opt, transport, ...) -> step_fn
    config: object  # the EFFECTIVE config (overrides applied)
    device: object  # the torch.device everything lives on


def add_transport_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--transport", choices=("stacked", "ici", "tcp"), default="stacked",
        help="'stacked': all peers on ONE device as a stacked axis; 'tcp': "
        "this process is the node --name, one process per node (the MNIST "
        "example); 'ici' raises (not ported yet)",
    )
    ap.add_argument("--name", help="this process's node name (--transport tcp)")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs the plain "
        "merges on the CPU on purpose)",
    )
    ap.add_argument(
        "--wire-dtype", default=None, choices=("f32", "bf16", "int8"),
        help="override protocol.wire_dtype (bf16: the partner's replica is "
        "rounded to bf16, as if shipped at half the bytes; int8: "
        "stochastically rounded to int8 with a float32 scale per 256 "
        "elements)",
    )
    ap.add_argument(
        "--mode", default=None, choices=("pairwise", "pull"),
        help="override protocol.mode (pull: one-sided pull maps)",
    )
    ap.add_argument(
        "--fetch-probability", type=float, default=None,
        help="override protocol.fetch_probability (each pair's per-step "
        "chance to exchange)",
    )
    ap.add_argument(
        "--drop-probability", type=float, default=None,
        help="override protocol.drop_probability (injected exchange faults)",
    )


def apply_overrides(cfg, wire_dtype: Optional[str] = None, mode: Optional[str] = None,
                    fetch_probability: Optional[float] = None,
                    drop_probability: Optional[float] = None):
    """``cfg`` with the given ``protocol`` fields overridden (None =
    unchanged); ``dataclasses.replace`` re-runs validation."""
    given = (("wire_dtype", wire_dtype), ("mode", mode),
             ("fetch_probability", fetch_probability), ("drop_probability", drop_probability))
    changes = {k: v for k, v in given if v is not None}
    if not changes:
        return cfg
    return dataclasses.replace(
        cfg, protocol=dataclasses.replace(cfg.protocol, **changes)
    )


def build_transport(
    cfg,
    transport: str = "stacked",
    device=None,
    wire_dtype: Optional[str] = None,
    mode: Optional[str] = None,
    fetch_probability: Optional[float] = None,
    drop_probability: Optional[float] = None,
    name: Optional[str] = None,
) -> TransportBundle:
    """Construct the transport on ``device`` (the CUDA card by default,
    raising without one); returns a :class:`TransportBundle`.  ``tcp``
    needs this process's node ``name``; its bundle's ``init_state`` and
    ``make_step`` raise, since a TCP node trains its one replica in the
    example's own loop."""
    if transport not in ("stacked", "tcp"):
        raise NotImplementedError(
            f"transport {transport!r} is not ported to dpwa_tpu_torch yet; "
            "use 'stacked' or 'tcp'"
        )
    cfg = apply_overrides(cfg, wire_dtype, mode, fetch_probability, drop_probability)
    if transport == "tcp":
        if not name:
            raise ValueError("--transport tcp needs --name (this node's name in the config)")
        from dpwa_tpu_torch.parallel.tcp import TcpTransport

        t = TcpTransport(cfg, name, device=device)

        def stacked_only(*_args, **_kwargs):
            raise NotImplementedError(
                "a tcp node trains one replica in its own loop; only the MNIST "
                "example runs --transport tcp"
            )

        return TransportBundle(t, stacked_only, stacked_only, cfg, t.device)
    from dpwa_tpu_torch.parallel.stacked import (
        StackedTransport,
        init_stacked_state,
        make_stacked_train_step,
    )

    t = StackedTransport(cfg, device=device)
    return TransportBundle(
        transport=t,
        init_state=init_stacked_state,
        make_step=make_stacked_train_step,
        config=cfg,
        device=t.device,
    )
