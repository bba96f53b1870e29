"""Central registry of threefry control-tag allocations.

A copy of :mod:`dpwa_tpu.utils.tags` (pure Python), so that the port draws
on the same streams without importing the reference package; the tests
hold the two registries equal.

Every host-side control decision (participation, faults, partner pools,
relay probes, chaos, replica sketches …) draws from a counter-based
threefry stream keyed by ``schedules._pair_key(seed, step, pair_id, tag)``.
The ``tag`` is what keeps the streams independent: two draws that share a
tag share a stream, and a collision silently correlates decisions that
the convergence analysis assumes are independent.  This module is the
single place tags are allocated — registering the same integer twice
raises at import time, and ``dpwalint``'s determinism checker rejects any
raw tag literal that does not come from here.

Layout of the tag space:

- ``0 .. 15``  first control-plane block (below) — FULL as of the
  island-churn draw; new control draws go in the second block.
- ``16 .. 31`` chaos fault-kind streams: ``CHAOS_TAG_BASE + kind`` where
  ``kind`` is one of the ``CHAOS_KIND_*`` indices below (13 of 16 kinds
  allocated; the remaining three stay reserved for future fault kinds so
  chaos never has to renumber).
- ``32 .. 47`` second control-plane block (``CONTROL_TAG_BASE_2``),
  opened for the shard-schedule draw once 0..15 filled.  Allocate new
  control draws here, bottom-up; when THIS block fills, open 48..63 and
  extend this comment.

The int8 stochastic-rounding stream in ``ops/quantize.py`` is keyed on a
separate ``fold_in(fold_in(key, step), sender)`` chain (no control tag)
and deliberately does not live in this space.
"""

from __future__ import annotations

from typing import Dict

_TAG_REGISTRY: Dict[int, str] = {}


def _register(name: str, value: int) -> int:
    """Allocate control tag ``value`` to ``name``; collision = error."""
    if value in _TAG_REGISTRY:
        raise ValueError(
            "threefry control-tag collision: tag %d already registered as"
            " %r, cannot also register %r"
            % (value, _TAG_REGISTRY[value], name)
        )
    _TAG_REGISTRY[value] = name
    return value


# Control-plane draws (one tag per independent decision stream).
TAG_PARTICIPATION = _register("participation_draw", 0)
TAG_FAULT = _register("fault_draw", 1)
TAG_POOL_BRANCH = _register("pool_branch_draw", 2)
TAG_FALLBACK = _register("fallback_draw", 3)
TAG_BACKOFF_JITTER = _register("backoff_jitter_draw", 4)
TAG_DONOR = _register("bootstrap_donor_draw", 5)
TAG_RELAY_PROBE = _register("relay_probe_draw", 6)
TAG_HEAL_DONOR = _register("heal_donor_draw", 7)
TAG_DEGRADE_SHED = _register("degrade_shed_draw", 8)
TAG_SKETCH = _register("replica_sketch_draw", 9)
# Fleet churn-schedule draws (dpwa_tpu/fleet): per-(round, peer) leave /
# join decisions, per-round cohort-arrival sizing, and the rolling-restart
# cursor.  Independent streams so a leave-heavy schedule does not skew
# which peers restart.
TAG_CHURN_LEAVE = _register("churn_leave_draw", 10)
TAG_CHURN_JOIN = _register("churn_join_draw", 11)
TAG_CHURN_COHORT = _register("churn_cohort_draw", 12)
TAG_CHURN_RESTART = _register("churn_restart_draw", 13)
# Hierarchical gossip (dpwa_tpu/hier): the per-(island, term) leader
# election draw and the fleet's whole-island churn decisions.  Separate
# streams so island membership churn cannot skew which member wins the
# leadership draw.
TAG_LEADER = _register("leader_draw", 14)
TAG_ISLAND_CHURN = _register("island_churn_draw", 15)

# Chaos fault-kind streams occupy CHAOS_TAG_BASE + kind.
CHAOS_TAG_BASE = 16

_CHAOS_KIND_REGISTRY: Dict[int, str] = {}


def _register_chaos_kind(name: str, kind: int) -> int:
    """Allocate chaos kind ``kind``; collides against both registries."""
    if kind in _CHAOS_KIND_REGISTRY:
        raise ValueError(
            "chaos fault-kind collision: kind %d already registered as"
            " %r, cannot also register %r"
            % (kind, _CHAOS_KIND_REGISTRY[kind], name)
        )
    _CHAOS_KIND_REGISTRY[kind] = name
    # The kind's absolute tag must not shadow a control tag either.
    _register("chaos:" + name, CHAOS_TAG_BASE + kind)
    return kind


# Wire faults (health/chaos.py _PRIORITY order is behavioral priority,
# not tag order).
CHAOS_KIND_DROP = _register_chaos_kind("drop", 0)
CHAOS_KIND_DELAY = _register_chaos_kind("delay", 1)
CHAOS_KIND_THROTTLE = _register_chaos_kind("throttle", 2)
CHAOS_KIND_TRUNCATE = _register_chaos_kind("truncate", 3)
CHAOS_KIND_CORRUPT = _register_chaos_kind("corrupt", 4)
# Drawn partitions: kind 5 decides whether a time block is split (drawn
# once per block, peer key 0); kind 6 assigns each peer a side.
CHAOS_KIND_PARTITION = _register_chaos_kind("partition", 5)
CHAOS_KIND_PARTITION_SIDE = _register_chaos_kind("partition_side", 6)
# Byzantine content faults (served frame stays wire-valid; only the
# vector content lies — see health/chaos.py byzantine_frame).
CHAOS_KIND_BYZ_SIGN = _register_chaos_kind("byz_sign", 7)
CHAOS_KIND_BYZ_SCALE = _register_chaos_kind("byz_scale", 8)
CHAOS_KIND_BYZ_REPLAY = _register_chaos_kind("byz_replay", 9)
CHAOS_KIND_BYZ_ZERO = _register_chaos_kind("byz_zero", 10)
# Flowctl shaping (slow-peer chaos): STALL decides whether this
# (round, peer) stalls mid-frame, STALL_LEN draws the stall length as a
# fraction of ``stall_ms_max`` — both independent of the wire-fault
# draws, so a trickled peer can ALSO stall, like a real overloaded box.
CHAOS_KIND_STALL = _register_chaos_kind("stall", 11)
CHAOS_KIND_STALL_LEN = _register_chaos_kind("stall_len", 12)
# Link-quality flapping (health/chaos.py bandwidth_bps): BANDWIDTH_FLAP
# gates whether a (round-block, peer) is inside a flap window at all,
# BANDWIDTH_RATE draws where inside [bandwidth_bps_min, max] the shaped
# throughput lands.  Two streams so the flap duty cycle cannot skew how
# deep the shaping goes — the tune controller's escalate→backoff→dwell
# path is exercised against both axes independently.
CHAOS_KIND_BANDWIDTH_FLAP = _register_chaos_kind("bandwidth_flap", 13)
CHAOS_KIND_BANDWIDTH_RATE = _register_chaos_kind("bandwidth_rate", 14)

# Second control-plane block (0..15 filled; 16..31 belongs to chaos).
CONTROL_TAG_BASE_2 = 32

# Sharded gossip (ops/shard.py + schedules.shard_draw): the per-epoch
# shard-visit permutation.  Keyed on the publish clock, so a pair of
# free-running peers lands on the same shard each round without any
# negotiation, and every shard is visited exactly once per k rounds.
TAG_SHARD = _register("shard_draw", CONTROL_TAG_BASE_2 + 0)

# Barrier-free async rounds (parallel/async_loop.py +
# schedules.async_drain_draw): tie-break rotation for the deterministic
# drain order when several peers have frames pending at the same publish
# clock.  Keyed on the local step, so a rerun of the same soak drains
# queues in the same order regardless of arrival timing.
TAG_ASYNC_DRAIN = _register("async_drain_draw", CONTROL_TAG_BASE_2 + 1)

# Bounded partial views (membership/partial_view.py +
# schedules.view_sample_draw): which tracked peers land in this frame's
# truncated digest.  Keyed on the publish clock, so a seeded rerun
# publishes byte-identical digests and two observers of the same node
# see the same sample.
TAG_VIEW_SAMPLE = _register("view_sample_draw", CONTROL_TAG_BASE_2 + 2)

# Passive-view shuffle (schedules.passive_shuffle_draw): which passive
# candidate is promoted into the active view when an active peer fails,
# and which resident it displaces when the reservoir is full.  A stream
# separate from the sample draw so digest truncation cannot skew
# replacement choices.
TAG_PASSIVE_SHUFFLE = _register("passive_shuffle_draw", CONTROL_TAG_BASE_2 + 3)

# Training-harness data order (run/harness.py +
# schedules.data_shuffle_draw): each node's per-epoch shard permutation.
# Keyed on ``(seed, epoch, node)``, so a seeded rerun replays the exact
# batch sequence with no stream state to checkpoint, and a rejoining
# node lands on the same data order as the run it crashed out of.
TAG_DATA_SHUFFLE = _register("data_shuffle_draw", CONTROL_TAG_BASE_2 + 4)

# Self-tuning wire (tune/controller.py + schedules.tune_jitter_draw):
# the per-(link, clock) dwell-jitter offset that desynchronizes ladder
# escalations across links.  Without it, every wire-bound link clears
# its dwell on the same round and the whole fleet's codecs step in
# lock-step — a thundering herd the per-link controller exists to avoid.
# Keyed on the publish clock like shard_draw, so both ends of a link
# (and a seeded rerun) draw the same offset with no negotiation.
TAG_TUNE_JITTER = _register("tune_jitter_draw", CONTROL_TAG_BASE_2 + 5)


def registered_tags() -> Dict[int, str]:
    """A copy of the full tag → name allocation map (chaos included)."""
    return dict(_TAG_REGISTRY)


def registered_chaos_kinds() -> Dict[int, str]:
    """A copy of the chaos kind → name allocation map."""
    return dict(_CHAOS_KIND_REGISTRY)
