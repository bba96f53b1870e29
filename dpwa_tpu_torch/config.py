"""Reference-compatible YAML configuration (the port of
:mod:`dpwa_tpu.config`, for the blocks the stacked trainer reads).

The same YAML file that drives ``dpwa_tpu`` drives the port: ``nodes:``
lists the peers (its length is the stacked peer axis; host/port are where
each node of the TCP transport serves), ``protocol:`` the schedule,
``interpolation:`` the merge coefficient, ``recovery:`` the guard, the
rollback ring, the STATE wire and the bound of the α = 1 rescue, and
``health:`` the TCP transport's failure detector and scoreboard.  The
reference turns its ``membership:``, ``trust:`` and ``flowctl:`` planes on
by default and the port has none of them yet: such a block loads when it
says only ``enabled: false``, and any other content raises
:class:`NotImplementedError` naming it, as does every other top-level block
of a plane the port does not have, rather than dropping it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import yaml

# The TCP liveness floor (MEGABYTES/s), as in dpwa_tpu.config.
DEFAULT_MIN_WIRE_MB_PER_S = 10.0

# The top-level blocks the port reads.
PORTED_BLOCKS = ("nodes", "protocol", "interpolation", "recovery", "health")
# Default-on planes of the reference that the port does not have yet: a
# block of theirs may only switch the plane off.
UNPORTED_DEFAULT_ON = ("membership", "trust", "flowctl")


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
    the outcome sequence.  ``healthz_port`` is validated and must stay
    null: the ``/healthz`` endpoint is not ported yet."""

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
class DpwaConfig:
    nodes: tuple[NodeSpec, ...]
    protocol: ProtocolConfig = ProtocolConfig()
    interpolation: InterpolationConfig = InterpolationConfig()
    recovery: RecoveryConfig = RecoveryConfig()
    health: HealthConfig = HealthConfig()
    # The reference's default-on planes that this config switched off.
    disabled_planes: tuple[str, ...] = ()

    def unported_planes(self) -> tuple[str, ...]:
        """The reference's default-on planes that a node of the reference
        would run under this config and a port node runs without."""
        return tuple(p for p in UNPORTED_DEFAULT_ON if p not in self.disabled_planes)

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

    Raises :class:`NotImplementedError` naming any other top-level block,
    and a ``membership:``, ``trust:`` or ``flowctl:`` block that says more
    than ``enabled: false``: the port has no plane that would read it."""
    if "nodes" not in raw:
        raise ValueError("config is missing the required 'nodes:' list")
    disabled = []
    for key in raw:
        if key in UNPORTED_DEFAULT_ON and dict(raw[key] or {}) == {"enabled": False}:
            disabled.append(key)
        elif key not in PORTED_BLOCKS:
            raise NotImplementedError(
                f"config block {key!r} is not ported to dpwa_tpu_torch yet"
                + (" (only 'enabled: false' is accepted)" if key in UNPORTED_DEFAULT_ON else "")
            )
    proto = dict(raw.get("protocol") or {})
    if "async_rounds" in proto:
        raise NotImplementedError(
            "config block 'protocol.async_rounds' is not ported to "
            "dpwa_tpu_torch yet"
        )
    return DpwaConfig(
        nodes=_build_nodes(raw["nodes"]),
        protocol=ProtocolConfig(**proto),
        interpolation=InterpolationConfig(**dict(raw.get("interpolation") or {})),
        recovery=RecoveryConfig(**dict(raw.get("recovery") or {})),
        health=HealthConfig(**dict(raw.get("health") or {})),
        disabled_planes=tuple(disabled),
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
    disabled_planes: tuple[str, ...] = (),
    **protocol_kwargs: Any,
) -> DpwaConfig:
    """Programmatic config for tests and benchmarks: n local peers.
    ``disabled_planes`` names the unported default-on planes switched off
    (as ``membership: {enabled: false}`` and so on in a file)."""
    if isinstance(recovery, Mapping):
        recovery = RecoveryConfig(**recovery)
    if isinstance(health, Mapping):
        health = HealthConfig(**health)
    unknown = set(disabled_planes) - set(UNPORTED_DEFAULT_ON)
    if unknown:
        raise ValueError(f"disabled_planes names no unported plane: {sorted(unknown)}")
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
        recovery=recovery if recovery is not None else RecoveryConfig(),
        health=health if health is not None else HealthConfig(),
        disabled_planes=tuple(disabled_planes),
    )
