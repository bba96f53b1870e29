"""Reference-compatible YAML configuration (the port of
:mod:`dpwa_tpu.config`, for the blocks the stacked trainer reads).

The same YAML file that drives ``dpwa_tpu`` drives the port: ``nodes:``
lists the peers (its length is the stacked peer axis; host/port are where
each node of the TCP transport serves), ``protocol:`` the schedule,
``interpolation:`` the merge coefficient, ``recovery:`` the guard, the
rollback ring, the STATE wire and the bound of the α = 1 rescue,
``health:`` the TCP transport's failure detector, scoreboard and
``/healthz`` port, ``membership:`` the epidemic membership plane (its
global view: a ``view:`` block loads only as ``enabled: false``),
``trust:`` the content-trust screen, ``flowctl:`` the flow control plane
(adaptive deadlines, hedged fetches, degrade shedding, serving admission)
and ``chaos:`` the seeded fault injection of the TCP path.  Every other
top-level block raises :class:`NotImplementedError` naming it, rather than
being dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import yaml

# The TCP liveness floor (MEGABYTES/s), as in dpwa_tpu.config.
DEFAULT_MIN_WIRE_MB_PER_S = 10.0

# The top-level blocks the port reads.
PORTED_BLOCKS = (
    "nodes", "protocol", "interpolation", "recovery", "health", "membership", "trust",
    "flowctl", "chaos",
)
# The planes make_local_config's ``disabled_planes`` may switch off.
DEFAULT_ON_PLANES = ("membership", "trust", "flowctl")


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One ``nodes:`` entry: a peer's identity and (TCP-only) address."""

    name: str
    host: str = "127.0.0.1"
    port: int = 0


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """``protocol:`` block.  The TCP-only knobs (``timeout_ms``,
    ``min_wire_mb_per_s``, ``wire_codec``, ``topk_*``,
    ``overlap_prefetch``, ``rx_server``) are validated as in the reference
    and unused by the stacked transport, as there; the TCP transport reads
    ``timeout_ms`` and ``min_wire_mb_per_s`` and raises for the values that
    ask for what it does not have yet (``wire_dtype: int8``, ``wire_codec:
    topk``, ``overlap_prefetch: true``, ``rx_server: reactor``);
    ``async_rounds`` is a TCP plane the port does not have (see
    :func:`config_from_dict`)."""

    schedule: str = "ring"
    mode: str = "pairwise"  # pairwise (mutual merge) | pull (one-sided)
    fetch_probability: float = 1.0
    timeout_ms: int = 500
    min_wire_mb_per_s: float = DEFAULT_MIN_WIRE_MB_PER_S
    seed: int = 0
    pool_size: int | None = None
    group_size: int = 0
    inter_period: int = 4
    drop_probability: float = 0.0
    wire_dtype: str = "f32"
    wire_codec: str = "dense"
    topk_fraction: float = 0.05
    topk_values: str = "int8"
    overlap_prefetch: bool = False
    rx_server: str = "threaded"

    def __post_init__(self) -> None:
        if not 0.0 <= self.fetch_probability <= 1.0:
            raise ValueError(
                f"fetch_probability must be in [0, 1], got {self.fetch_probability}"
            )
        if not 0.0 <= self.drop_probability <= 1.0:
            raise ValueError(
                f"drop_probability must be in [0, 1], got {self.drop_probability}"
            )
        if self.schedule not in (
            "ring", "random", "hierarchical", "exponential"
        ):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.mode not in ("pairwise", "pull"):
            raise ValueError(f"unknown protocol mode {self.mode!r}")
        if self.wire_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}")
        if self.wire_codec not in ("dense", "topk"):
            raise ValueError(f"unknown wire_codec {self.wire_codec!r}")
        if not 0.0 < self.topk_fraction <= 1.0:
            raise ValueError(
                f"topk_fraction must be in (0, 1], got {self.topk_fraction}"
            )
        if self.topk_values not in ("int8", "f32"):
            raise ValueError(f"unknown topk_values {self.topk_values!r}")
        if self.min_wire_mb_per_s <= 0:
            raise ValueError(
                f"min_wire_mb_per_s must be > 0, got {self.min_wire_mb_per_s}"
            )
        if self.pool_size is not None and self.pool_size < 1:
            raise ValueError(
                f"pool_size must be >= 1 (or null for auto), "
                f"got {self.pool_size}"
            )
        if self.rx_server not in ("threaded", "reactor"):
            raise ValueError(f"unknown rx_server {self.rx_server!r}")

    def resolved_pool_size(self, n_peers: int) -> int:
        """The random-schedule pool size in effect for ``n_peers``."""
        if self.pool_size is not None:
            return self.pool_size
        return max(16, min(128, 2 * n_peers))


@dataclasses.dataclass(frozen=True)
class InterpolationConfig:
    type: str = "constant"
    factor: float = 0.5

    def __post_init__(self) -> None:
        if self.type not in ("constant", "clock", "loss"):
            raise ValueError(f"unknown interpolation type {self.type!r}")
        if not 0.0 <= self.factor <= 1.0:
            raise ValueError(f"factor must be in [0, 1], got {self.factor}")


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """``recovery:`` block.  The stacked trainer reads only ``enabled`` and
    :meth:`rescue_bound` (the interpolation's α = 1 rescue threshold); the
    TCP transport and adapter read the rest: the guard's bounds, the
    rollback ring, the STATE wire's chunks, deadline and retries, and the
    re-sync's ``max_clock_lag`` and ``auto_resync``."""

    enabled: bool = True
    max_param_norm: float = 1e12
    max_loss: float = 1e9
    rescue_loss: "float | None" = None
    min_param_norm_ratio: float = 1e-4
    snapshot_every: int = 1
    snapshot_ring: int = 4
    state_chunk_bytes: int = 1 << 20
    bootstrap_timeout_ms: int = 10000
    max_resume_retries: int = 8
    max_clock_lag: float = 64.0
    auto_resync: bool = False

    def __post_init__(self) -> None:
        if self.max_param_norm <= 0:
            raise ValueError(
                f"max_param_norm must be > 0, got {self.max_param_norm}"
            )
        if self.max_loss <= 0:
            raise ValueError(f"max_loss must be > 0, got {self.max_loss}")
        if self.rescue_loss is not None and self.rescue_loss < self.max_loss:
            raise ValueError(
                f"rescue_loss must be >= max_loss ({self.max_loss}) — a "
                f"rescue below the guard bound would adopt a peer replica "
                f"wholesale on losses the guard still tolerates; got "
                f"{self.rescue_loss}"
            )
        for name, low in (
            ("snapshot_every", 1), ("snapshot_ring", 1),
            ("state_chunk_bytes", 64), ("bootstrap_timeout_ms", 1),
            ("max_resume_retries", 0),
        ):
            if getattr(self, name) < low:
                raise ValueError(
                    f"{name} must be >= {low}, got {getattr(self, name)}"
                )
        if self.max_clock_lag <= 0:
            raise ValueError(
                f"max_clock_lag must be > 0, got {self.max_clock_lag}"
            )
        if not 0.0 <= self.min_param_norm_ratio < 1.0:
            raise ValueError(
                f"min_param_norm_ratio must be in [0, 1), "
                f"got {self.min_param_norm_ratio}"
            )

    def rescue_bound(self) -> float:
        """The |loss| threshold for the interpolation α = 1 rescue:
        ``rescue_loss`` when configured, else ``16 * max_loss``."""
        if self.rescue_loss is not None:
            return float(self.rescue_loss)
        return 16.0 * float(self.max_loss)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """``health:`` block: the TCP transport's peer-health plane (the
    reference's fields and defaults).  Quarantine timing is counted in
    gossip rounds, never wall time, so the plane's state is a function of
    the outcome sequence.  ``healthz_port`` (null: off, 0: a port the OS
    picks) serves the health snapshot at ``/healthz``."""

    enabled: bool = True
    # Quarantine when a peer's suspicion crosses this (about 1 per hard
    # failure: the default is two hard failures in a row).
    suspicion_threshold: float = 2.0
    ewma_alpha: float = 0.2
    success_decay: float = 0.25
    quarantine_base_rounds: int = 4
    quarantine_max_rounds: int = 64
    jitter_rounds: int = 2
    probe_timeout_ms: int = 100
    healthz_port: int | None = None

    def __post_init__(self) -> None:
        if self.suspicion_threshold <= 0:
            raise ValueError(
                f"suspicion_threshold must be > 0, got {self.suspicion_threshold}"
            )
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        if not 0.0 <= self.success_decay < 1.0:
            raise ValueError(
                f"success_decay must be in [0, 1), got {self.success_decay}"
            )
        if self.quarantine_base_rounds < 1:
            raise ValueError(
                f"quarantine_base_rounds must be >= 1, got {self.quarantine_base_rounds}"
            )
        if self.quarantine_max_rounds < self.quarantine_base_rounds:
            raise ValueError("quarantine_max_rounds must be >= quarantine_base_rounds")
        if self.jitter_rounds < 0:
            raise ValueError(f"jitter_rounds must be >= 0, got {self.jitter_rounds}")
        if self.probe_timeout_ms < 1:
            raise ValueError(f"probe_timeout_ms must be >= 1, got {self.probe_timeout_ms}")
        if self.healthz_port is not None and not 0 <= self.healthz_port < 65536:
            raise ValueError(
                f"healthz_port must be in [0, 65535] or null, got {self.healthz_port}"
            )


@dataclasses.dataclass(frozen=True)
class MembershipConfig:
    """``membership:`` block: epidemic membership and partition tolerance
    on the TCP transport (the reference's fields, defaults and checks).
    Every frame carries the sender's digest of its view; receivers fold it
    into theirs.  Needs ``health.enabled`` (the digest is the scoreboard's
    view).  Decisions count gossip rounds and threefry draws, never wall
    time.  The partial view (``view:``) is not ported: the block loads
    only as ``view: {enabled: false}``."""

    enabled: bool = True
    # Before quarantining a peer on its own evidence, ask this many drawn
    # healthy peers to header-probe it (0: quarantine on own evidence).
    indirect_probes: int = 2
    relay_timeout_ms: int = 250
    # A quarantined peer that fails this many re-admission probes in a row
    # is disseminated as dead.
    dead_after_quarantines: int = 3
    # Held dead this many further rounds, a peer is evicted (0: never).
    dead_gossip_rounds: int = 16
    # Degraded when |component| / ring size falls strictly below this.
    quorum_fraction: float = 0.5
    # α is scaled by this while degraded (1.0: off).
    degraded_alpha_scale: float = 1.0
    # On a heal, merge with a drawn donor of the returning side.
    heal_reconcile: bool = True
    reconcile_min_fraction: float = 0.3
    max_heal_weight: float = 0.75
    # The partial view's block: only ``{"enabled": False}`` (or none)
    # loads, and is kept as None.
    view: Any = None

    def __post_init__(self) -> None:
        view = dict(self.view or {"enabled": False})
        if view != {"enabled": False}:
            raise NotImplementedError(
                f"membership.view: {view} (the partial view) is not ported to "
                f"dpwa_tpu_torch yet (only 'enabled: false' is accepted)"
            )
        object.__setattr__(self, "view", None)
        if self.indirect_probes < 0:
            raise ValueError(f"indirect_probes must be >= 0, got {self.indirect_probes}")
        if self.relay_timeout_ms < 1:
            raise ValueError(f"relay_timeout_ms must be >= 1, got {self.relay_timeout_ms}")
        if self.dead_after_quarantines < 1:
            raise ValueError(
                f"dead_after_quarantines must be >= 1, got {self.dead_after_quarantines}"
            )
        if self.dead_gossip_rounds < 0:
            raise ValueError(f"dead_gossip_rounds must be >= 0, got {self.dead_gossip_rounds}")
        if not 0.0 <= self.quorum_fraction <= 1.0:
            raise ValueError(f"quorum_fraction must be in [0, 1], got {self.quorum_fraction}")
        if not 0.0 < self.degraded_alpha_scale <= 1.0:
            raise ValueError(
                f"degraded_alpha_scale must be in (0, 1], got {self.degraded_alpha_scale}"
            )
        if not 0.0 <= self.reconcile_min_fraction <= 1.0:
            raise ValueError(
                f"reconcile_min_fraction must be in [0, 1], got {self.reconcile_min_fraction}"
            )
        if not 0.0 < self.max_heal_weight <= 1.0:
            raise ValueError(f"max_heal_weight must be in (0, 1], got {self.max_heal_weight}")


@dataclasses.dataclass(frozen=True)
class TrustConfig:
    """``trust:`` block: the content-trust screen of every fetched frame
    (the reference's fields, defaults and checks).  It arms after
    ``min_window`` accepted exchanges; a fully trusted peer's α scale snaps
    to exactly 1.0, so an honest ring merges bit for bit as with trust
    off.  Needs ``health.enabled`` for the quarantine feedback."""

    enabled: bool = True
    # Median/MAD window over accepted exchanges, and its arming fill.
    window: int = 32
    min_window: int = 8
    # Robust z at or above these: suspect (damped), rejected.
    mad_multiplier: float = 8.0
    reject_multiplier: float = 24.0
    # A suspect merges at α · trust ** damping.
    damping: float = 1.0
    ewma_half_life: float = 4.0
    suspect_decay: float = 0.7
    reject_decay: float = 0.25
    # Below this trust every screening feeds an ``untrusted`` probe.
    quarantine_trust: float = 0.15
    # Hard bounds once armed: a sign-flip's cosine, a scale blow-up.
    cosine_floor: float = -0.5
    norm_ratio_max: float = 64.0
    # A publish clock may run back this much before it counts as a replay.
    replay_slack: float = 0.5
    # A peer unscreened for more than amnesty_gap · (n_peers - 1) rounds
    # gets amnesty_rounds lenient screenings (0 on either: no amnesty).
    amnesty_gap: int = 4
    amnesty_rounds: int = 8

    def __post_init__(self) -> None:
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {self.window}")
        if not 1 <= self.min_window <= self.window:
            raise ValueError(f"min_window must be in [1, window], got {self.min_window}")
        if self.mad_multiplier <= 0:
            raise ValueError(f"mad_multiplier must be > 0, got {self.mad_multiplier}")
        if self.reject_multiplier < self.mad_multiplier:
            raise ValueError(
                "reject_multiplier must be >= mad_multiplier, "
                f"got {self.reject_multiplier} < {self.mad_multiplier}"
            )
        if self.damping <= 0:
            raise ValueError(f"damping must be > 0, got {self.damping}")
        if self.ewma_half_life <= 0:
            raise ValueError(f"ewma_half_life must be > 0, got {self.ewma_half_life}")
        for name in ("suspect_decay", "reject_decay"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if not 0.0 < self.quarantine_trust < 1.0:
            raise ValueError(f"quarantine_trust must be in (0, 1), got {self.quarantine_trust}")
        if not -1.0 <= self.cosine_floor <= 1.0:
            raise ValueError(f"cosine_floor must be in [-1, 1], got {self.cosine_floor}")
        if self.norm_ratio_max <= 1.0:
            raise ValueError(f"norm_ratio_max must be > 1, got {self.norm_ratio_max}")
        if self.replay_slack < 0:
            raise ValueError(f"replay_slack must be >= 0, got {self.replay_slack}")
        for name in ("amnesty_gap", "amnesty_rounds"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0:
                raise ValueError(f"{name} must be a non-negative int, got {v!r}")


@dataclasses.dataclass(frozen=True)
class FlowctlConfig:
    """``flowctl:`` block: the flow control plane of the TCP transport (the
    reference's fields, defaults and checks).  Fetcher side: each peer's
    success latencies set its next fetch's deadline (their ``quantile``
    times ``margin``, clamped to ``[min_ms, max_ms]``; ``protocol.timeout_ms``
    until ``warmup`` samples), and once the un-margined quantile lapses one
    hedged fetch races the schedule's fallback partner; a ``degraded``
    partner's rounds go to a fallback at ``degrade_shed_fraction``.
    Serving side: admission sheds excess connections, a drained per-remote
    token bucket and sends past ``max_inflight_bytes`` with a ``DPWB`` busy
    frame, and evicts a request that trickles in slower than
    ``min_ingest_bytes_per_s``.  ``reactor_max_connections`` is validated
    and unused (the port has no reactor Rx server)."""

    enabled: bool = True
    quantile: float = 0.95
    margin: float = 1.5
    min_ms: float = 50.0
    max_ms: float = 5000.0
    window: int = 32
    warmup: int = 5
    hedge: bool = True
    degrade_shed_fraction: float = 0.5
    max_connections: int = 32
    reactor_max_connections: int = 1024
    token_rate: float = 100.0
    token_burst: float = 200.0
    max_inflight_bytes: int = 1 << 28
    min_ingest_bytes_per_s: float = 4096.0
    # The handler's socket budget and the request read's eviction deadline.
    request_timeout_ms: int = 5000
    busy_retry_ms: int = 50

    def __post_init__(self) -> None:
        if not 0.0 < self.quantile <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {self.quantile}")
        if self.margin < 1.0:
            raise ValueError(f"margin must be >= 1, got {self.margin}")
        if not 0.0 < self.min_ms <= self.max_ms:
            raise ValueError(
                f"need 0 < min_ms <= max_ms, got min_ms={self.min_ms} max_ms={self.max_ms}"
            )
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {self.window}")
        if not 1 <= self.warmup <= self.window:
            raise ValueError(f"warmup must be in [1, window], got {self.warmup}")
        if not 0.0 <= self.degrade_shed_fraction <= 1.0:
            raise ValueError(
                f"degrade_shed_fraction must be in [0, 1], got {self.degrade_shed_fraction}"
            )
        for name, low in (("max_connections", 1), ("reactor_max_connections", 1),
                          ("max_inflight_bytes", 1), ("request_timeout_ms", 1),
                          ("busy_retry_ms", 0)):
            if getattr(self, name) < low:
                raise ValueError(f"{name} must be >= {low}, got {getattr(self, name)}")
        if self.token_rate <= 0:
            raise ValueError(f"token_rate must be > 0, got {self.token_rate}")
        if self.token_burst < 1:
            raise ValueError(f"token_burst must be >= 1, got {self.token_burst}")
        if self.min_ingest_bytes_per_s <= 0:
            raise ValueError(
                f"min_ingest_bytes_per_s must be > 0, got {self.min_ingest_bytes_per_s}"
            )


# ChaosConfig's fields that are a probability.
_CHAOS_PROBABILITIES = (
    "drop_probability", "delay_probability", "throttle_probability",
    "truncate_probability", "corrupt_probability", "partition_probability",
    "byzantine_sign_probability", "byzantine_scale_probability",
    "byzantine_replay_probability", "byzantine_zero_probability",
    "stall_probability", "bandwidth_flap_probability",
)
# ChaosConfig's window lists whose entries are (peer, start, stop).
_CHAOS_PEER_WINDOWS = ("down_windows", "trickle_windows", "accept_delay_windows",
                       "bandwidth_windows")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """``chaos:`` block: seeded fault injection on the TCP path (the
    reference's fields, defaults and checks; :mod:`dpwa_tpu_torch.health.
    chaos`).  Each fault is drawn per (seed, round, peer) on its own
    threefry stream, so a seed replays the same faults.  Windows are
    ``[start, stop)`` intervals of publish clocks: ``down_windows`` serve
    nothing, ``trickle_windows`` serve at ``trickle_bytes_per_s``,
    ``accept_delay_windows`` sleep before the request read,
    ``bandwidth_windows`` flap the serving rate block by block;
    ``partition_windows`` (a group and its complement) and ``link_windows``
    (one directed link) block links, and ``partition_probability`` draws
    partitions per block of ``partition_len_rounds``.  The byzantine faults
    keep the frame valid and lie in its payload."""

    enabled: bool = False
    seed: int = 0
    drop_probability: float = 0.0
    delay_probability: float = 0.0
    delay_ms: float = 50.0
    throttle_probability: float = 0.0
    throttle_bytes_per_s: float = 1e6
    truncate_probability: float = 0.0
    corrupt_probability: float = 0.0
    # (peer, start, stop) or {peer, start, stop}.
    down_windows: tuple = ()
    # (group, start, stop) or {group, start, stop}.
    partition_windows: tuple = ()
    # (src, dst, start, stop) or {src, dst, start, stop}.
    link_windows: tuple = ()
    partition_probability: float = 0.0
    partition_len_rounds: int = 8
    byzantine_peers: tuple = ()
    byzantine_start_round: int = 0
    byzantine_sign_probability: float = 0.0
    byzantine_scale_probability: float = 0.0
    byzantine_scale_factor: float = 100.0
    byzantine_replay_probability: float = 0.0
    byzantine_replay_age: int = 8
    byzantine_zero_probability: float = 0.0
    trickle_windows: tuple = ()
    trickle_bytes_per_s: float = 2048.0
    stall_probability: float = 0.0
    stall_ms_max: float = 200.0
    accept_delay_windows: tuple = ()
    accept_delay_ms: float = 100.0
    bandwidth_windows: tuple = ()
    bandwidth_flap_probability: float = 1.0
    bandwidth_block_rounds: int = 4
    bandwidth_bps_min: float = 4096.0
    bandwidth_bps_max: float = 65536.0

    def __post_init__(self) -> None:
        for name in _CHAOS_PROBABILITIES:
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        for name, positive in (("byzantine_scale_factor", True), ("throttle_bytes_per_s", True),
                               ("trickle_bytes_per_s", True), ("bandwidth_bps_min", True),
                               ("delay_ms", False), ("stall_ms_max", False),
                               ("accept_delay_ms", False)):
            v = getattr(self, name)
            if (v <= 0) if positive else (v < 0):
                raise ValueError(f"{name} must be {'>' if positive else '>='} 0, got {v}")
        for name, low in (("byzantine_replay_age", 1), ("byzantine_start_round", 0),
                          ("partition_len_rounds", 1), ("bandwidth_block_rounds", 1)):
            if getattr(self, name) < low:
                raise ValueError(f"{name} must be >= {low}, got {getattr(self, name)}")
        if self.bandwidth_bps_max < self.bandwidth_bps_min:
            raise ValueError(
                f"bandwidth_bps_max must be >= bandwidth_bps_min, "
                f"got {self.bandwidth_bps_max} < {self.bandwidth_bps_min}"
            )
        byz = tuple(int(p) for p in self.byzantine_peers)
        if any(p < 0 for p in byz):
            raise ValueError(f"bad byzantine_peers entry in {byz!r}")
        object.__setattr__(self, "byzantine_peers", byz)
        for field in _CHAOS_PEER_WINDOWS:
            windows = []
            for w in getattr(self, field):
                if isinstance(w, Mapping):
                    w = (w["peer"], w["start"], w["stop"])
                w = tuple(int(x) for x in w)
                if len(w) != 3 or w[0] < 0 or w[1] < 0 or w[2] < w[1]:
                    raise ValueError(f"bad {field} entry {w!r}")
                windows.append(w)
            object.__setattr__(self, field, tuple(windows))
        parts = []
        for w in self.partition_windows:
            if isinstance(w, Mapping):
                w = (w["group"], w["start"], w["stop"])
            group = tuple(sorted(int(p) for p in w[0]))
            start, stop = int(w[1]), int(w[2])
            if not group or min(group) < 0 or start < 0 or stop < start:
                raise ValueError(f"bad partition_windows entry {w!r}")
            parts.append((group, start, stop))
        object.__setattr__(self, "partition_windows", tuple(parts))
        links = []
        for w in self.link_windows:
            if isinstance(w, Mapping):
                w = (w["src"], w["dst"], w["start"], w["stop"])
            w = tuple(int(x) for x in w)
            if len(w) != 4 or min(w) < 0 or w[3] < w[2]:
                raise ValueError(f"bad link_windows entry {w!r}")
            links.append(w)
        object.__setattr__(self, "link_windows", tuple(links))


@dataclasses.dataclass(frozen=True)
class DpwaConfig:
    nodes: tuple[NodeSpec, ...]
    protocol: ProtocolConfig = ProtocolConfig()
    interpolation: InterpolationConfig = InterpolationConfig()
    recovery: RecoveryConfig = RecoveryConfig()
    health: HealthConfig = HealthConfig()
    membership: MembershipConfig = MembershipConfig()
    trust: TrustConfig = TrustConfig()
    flowctl: FlowctlConfig = FlowctlConfig()
    chaos: ChaosConfig = ChaosConfig()

    @property
    def n_peers(self) -> int:
        """Length of ``nodes:`` — the size of the stacked peer axis."""
        return len(self.nodes)

    @property
    def node_names(self) -> tuple[str, ...]:
        return tuple(n.name for n in self.nodes)

    def node_index(self, name: str) -> int:
        """Position of ``name`` in ``nodes:`` — the peer's row."""
        try:
            return self.node_names.index(name)
        except ValueError:
            raise KeyError(
                f"node {name!r} not in config (have {self.node_names})"
            ) from None


def _build_nodes(raw: Sequence[Any]) -> tuple[NodeSpec, ...]:
    nodes = []
    for i, entry in enumerate(raw):
        if isinstance(entry, str):
            nodes.append(NodeSpec(name=entry))
        elif isinstance(entry, Mapping):
            nodes.append(
                NodeSpec(
                    name=str(entry.get("name", f"node{i}")),
                    host=str(entry.get("host", "127.0.0.1")),
                    port=int(entry.get("port", 0)),
                )
            )
        else:
            raise TypeError(f"bad nodes[{i}] entry: {entry!r}")
    names = [n.name for n in nodes]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate node names in config: {names}")
    if not nodes:
        raise ValueError("config must list at least one node")
    return tuple(nodes)


def config_from_dict(raw: Mapping[str, Any]) -> DpwaConfig:
    """Build a :class:`DpwaConfig` from a parsed-YAML mapping.

    Raises :class:`NotImplementedError` naming any other top-level block and
    a ``membership.view`` that is on."""
    if "nodes" not in raw:
        raise ValueError("config is missing the required 'nodes:' list")
    for key in raw:
        if key not in PORTED_BLOCKS:
            raise NotImplementedError(f"config block {key!r} is not ported to dpwa_tpu_torch yet")
    proto = dict(raw.get("protocol") or {})
    if "async_rounds" in proto:
        raise NotImplementedError(
            "config block 'protocol.async_rounds' is not ported to "
            "dpwa_tpu_torch yet"
        )
    chaos = dict(raw.get("chaos") or {})
    for key in (*_CHAOS_PEER_WINDOWS, "partition_windows", "link_windows", "byzantine_peers"):
        if chaos.get(key) is not None:
            chaos[key] = tuple(chaos[key])
    return DpwaConfig(
        nodes=_build_nodes(raw["nodes"]),
        protocol=ProtocolConfig(**proto),
        interpolation=InterpolationConfig(**dict(raw.get("interpolation") or {})),
        recovery=RecoveryConfig(**dict(raw.get("recovery") or {})),
        health=HealthConfig(**dict(raw.get("health") or {})),
        membership=MembershipConfig(**dict(raw.get("membership") or {})),
        trust=TrustConfig(**dict(raw.get("trust") or {})),
        flowctl=FlowctlConfig(**dict(raw.get("flowctl") or {})),
        chaos=ChaosConfig(**chaos),
    )


def load_config(path: str) -> DpwaConfig:
    """Load the reference-style YAML config file."""
    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f)
    if not isinstance(raw, Mapping):
        raise ValueError(f"config file {path} did not parse to a mapping")
    return config_from_dict(raw)


def make_local_config(
    n_peers: int,
    *,
    schedule: str = "ring",
    fetch_probability: float = 1.0,
    interpolation: str = "constant",
    factor: float = 0.5,
    seed: int = 0,
    base_port: int = 45000,
    recovery: "RecoveryConfig | Mapping[str, Any] | None" = None,
    health: "HealthConfig | Mapping[str, Any] | None" = None,
    membership: "MembershipConfig | Mapping[str, Any] | None" = None,
    trust: "TrustConfig | Mapping[str, Any] | None" = None,
    flowctl: "FlowctlConfig | Mapping[str, Any] | None" = None,
    chaos: "ChaosConfig | Mapping[str, Any] | None" = None,
    disabled_planes: tuple[str, ...] = (),
    **protocol_kwargs: Any,
) -> DpwaConfig:
    """Programmatic config for tests and benchmarks: n local peers.  The
    blocks take a config object or its YAML mapping; ``disabled_planes``
    names default-on planes (``DEFAULT_ON_PLANES``) switched off, each as
    its ``{"enabled": False}`` block."""
    unknown = set(disabled_planes) - set(DEFAULT_ON_PLANES)
    if unknown:
        raise ValueError(f"disabled_planes names no default-on plane: {sorted(unknown)}")
    blocks = {"membership": membership, "trust": trust, "flowctl": flowctl}
    for plane in disabled_planes:
        given = blocks[plane]
        blocks[plane] = (dataclasses.replace(given, enabled=False) if dataclasses.is_dataclass(given)
                         else {**dict(given or {}), "enabled": False})
    types = {"recovery": RecoveryConfig, "health": HealthConfig, "membership": MembershipConfig,
             "trust": TrustConfig, "flowctl": FlowctlConfig, "chaos": ChaosConfig}
    given = {"recovery": recovery, "health": health, "chaos": chaos, **blocks}
    built = {
        name: (types[name](**value) if isinstance(value, Mapping)
               else types[name]() if value is None else value)
        for name, value in given.items()
    }
    return DpwaConfig(
        nodes=tuple(
            NodeSpec(name=f"node{i}", host="127.0.0.1", port=base_port + i)
            for i in range(n_peers)
        ),
        protocol=ProtocolConfig(
            schedule=schedule,
            fetch_probability=fetch_probability,
            seed=seed,
            **protocol_kwargs,
        ),
        interpolation=InterpolationConfig(type=interpolation, factor=factor),
        **built,
    )
