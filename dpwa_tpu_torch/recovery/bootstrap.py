"""Peer-assisted bootstrap: donor election, fetch, validate (the port of
:mod:`dpwa_tpu.recovery.bootstrap`).

A restarted worker has its config and a fresh init; this gets it a live
replica without shared disk:

1. header-probe every other peer, within the scoreboard's healthy mask
   when there is one;
2. elect a donor with :func:`~dpwa_tpu_torch.parallel.schedules.donor_draw`
   (threefry tag 5, keyed on (seed, step, me)): a rerun of the same crash
   elects the same donor, and rejoiners spread over the donors;
3. fetch the donor's packed state over the STATE wire and unpack it
   against the caller's template;
4. hold a single-vector state to the gossip guard: a diverged donor must
   not seed the rejoiner.

A donor that fails is excluded and the election repeats until the
candidates run out.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

from dpwa_tpu_torch.parallel.schedules import donor_draw
from dpwa_tpu_torch.parallel.tcp import TcpTransport, probe_header
from dpwa_tpu_torch.recovery.guard import validate_payload
from dpwa_tpu_torch.recovery.state_transfer import unpack_state


def choose_donor(
    me: int,
    n_peers: int,
    step: int,
    seed: int,
    healthy: Sequence[bool],
    exclude: Sequence[int] = (),
) -> Optional[int]:
    """The elected donor among the healthy peers other than ``me`` and
    those in ``exclude`` (in index order), or None when there is none."""
    excluded = set(exclude)
    candidates = [p for p in range(n_peers) if p != me and p not in excluded and healthy[p]]
    if not candidates:
        return None
    return candidates[donor_draw(seed, step, me, len(candidates))]


@dataclasses.dataclass
class BootstrapResult:
    """What a successful bootstrap hands the rejoiner."""

    donor: int
    state: Any  # the unpacked tree, or the flat list of leaves with like=None
    meta: dict  # the donor's metadata: clock, step, loss, ...
    nbytes: int  # bytes received over every attempt
    attempts: int  # donors tried, the one that served included
    latency_s: float


def bootstrap_from_peer(
    transport: TcpTransport,
    like: Any = None,
    step: int = 0,
    max_donors: Optional[int] = None,
) -> Optional[BootstrapResult]:
    """Fetch a whole state from an elected healthy donor, or None when no
    donor served a valid one (the caller keeps its own init).  ``like``
    is the template :func:`unpack_state` checks against; ``step`` keys the
    election."""
    t0 = time.monotonic()
    cfg = transport.config
    n, me = cfg.n_peers, transport.me
    sb_mask = (
        transport.scoreboard.healthy_mask() if transport.scoreboard is not None else [True] * n
    )
    healthy = []
    for p in range(n):
        if p == me or not sb_mask[p]:
            healthy.append(False)
            continue
        host, port = transport._ports[p]
        healthy.append(probe_header(host, port, cfg.health.probe_timeout_ms))
    tried: list = []
    nbytes_total = 0
    attempts = 0
    budget = max_donors if max_donors is not None else n
    while attempts < budget:
        donor = choose_donor(me, n, step, transport.schedule.seed, healthy, exclude=tried)
        if donor is None:
            return None
        attempts += 1
        blob, _outcome, _lat, nrx = transport.fetch_state(donor)
        nbytes_total += nrx
        tried.append(donor)
        if not blob:
            continue  # the transfer failed, or the donor has no state
        try:
            state, meta = unpack_state(blob, like=like)
        except ValueError:
            continue
        if like is None and isinstance(state, list) and len(state) == 1:
            if validate_payload(state[0], float(meta.get("loss", 0.0)), cfg.recovery):
                continue
        return BootstrapResult(
            donor=donor, state=state, meta=meta, nbytes=nbytes_total,
            attempts=attempts, latency_s=time.monotonic() - t0,
        )
    return None
