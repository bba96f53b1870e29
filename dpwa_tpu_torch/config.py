"""Reference-compatible YAML configuration (the port of
:mod:`dpwa_tpu.config`, for the blocks the stacked trainer reads).

The same YAML file that drives ``dpwa_tpu`` drives the port: ``nodes:``
lists the peers (its length is the stacked peer axis; host/port are where
each node of the TCP transport serves), ``protocol:`` the schedule,
``interpolation:`` the merge coefficient and ``recovery:`` the bound of the
α = 1 rescue.  Every other top-level block belongs to a plane the port does
not have yet; a file that sets one raises :class:`NotImplementedError`
naming it, rather than dropping it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import yaml

# The TCP liveness floor (MEGABYTES/s), as in dpwa_tpu.config.
DEFAULT_MIN_WIRE_MB_PER_S = 10.0

# The top-level blocks the stacked trainer reads.
PORTED_BLOCKS = ("nodes", "protocol", "interpolation", "recovery")


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
    other knobs serve the TCP guard and state transfer of the reference and
    are validated here so the same file loads in both packages."""

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
class DpwaConfig:
    nodes: tuple[NodeSpec, ...]
    protocol: ProtocolConfig = ProtocolConfig()
    interpolation: InterpolationConfig = InterpolationConfig()
    recovery: RecoveryConfig = RecoveryConfig()

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

    Raises :class:`NotImplementedError` naming any other top-level block:
    the port has no plane that would read it."""
    if "nodes" not in raw:
        raise ValueError("config is missing the required 'nodes:' list")
    for key in raw:
        if key not in PORTED_BLOCKS:
            raise NotImplementedError(
                f"config block {key!r} is not ported to dpwa_tpu_torch yet"
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
    **protocol_kwargs: Any,
) -> DpwaConfig:
    """Programmatic config for tests and benchmarks: n local peers."""
    if isinstance(recovery, Mapping):
        recovery = RecoveryConfig(**recovery)
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
    )
