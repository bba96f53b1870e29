"""Gossip pairing schedules (the port of :mod:`dpwa_tpu.parallel.schedules`).

A schedule materializes a small **pool** of static pairings at init (ring:
2; hierarchical: its period, deduplicated; exponential: log2 n) and each
step selects one pool row.  Pairwise pools are involutions (``perm[perm[i]]
== i``, the odd one out pairs with itself and sits the round out); pull
pools are one-sided maps with no self-pulls.  The pool builders are plain
numpy and give the reference's pools exactly.

A periodic schedule's row at ``step`` is ``branch_map[step % period]``;
the ``random`` schedule draws its row i.i.d. per step from the threefry
stream of :func:`pool_branch_draw` (:mod:`dpwa_tpu_torch.utils.prng`,
bit-equal to the reference's ``jax.random`` draw).  With
``fetch_probability < 1`` or ``drop_probability > 0`` each pair also draws,
per step, whether it exchanges (:func:`participation_draw`,
:func:`fault_draw`): on the host, from the same threefry streams as the
reference, and :meth:`Schedule.drawn` gives the round's mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from dpwa_tpu_torch.config import DpwaConfig
from dpwa_tpu_torch.utils import prng
from dpwa_tpu_torch.utils import tags as _tags


def _pair_key(seed: int, step: int, pair_id: int, tag: int) -> prng.Key:
    """The reference's ``_pair_key``: ``key(seed)`` with step, pair id and
    tag folded in, in that order (step and pair id as int32)."""
    k = prng.fold_in(prng.key(seed), step)
    return prng.fold_in(prng.fold_in(k, pair_id), tag)


def participation_draw(seed: int, step: int, pair_id: int, fetch_probability: float) -> bool:
    """One Bernoulli per (step, pair), shared by both members of a pair:
    the reference's ``uniform(_pair_key(seed, step, pair_id, 0)) <
    fetch_probability``, compared in float32 as jax compares it."""
    u = prng.uniform_scalar(_pair_key(seed, step, pair_id, _tags.TAG_PARTICIPATION))
    return bool(u < np.float32(fetch_probability))


def fault_draw(seed: int, step: int, pair_id: int, drop_probability: float) -> bool:
    """Fault injection: True means this pair's exchange is DROPPED (tag 1,
    independent of the participation stream)."""
    u = prng.uniform_scalar(_pair_key(seed, step, pair_id, _tags.TAG_FAULT))
    return bool(u < np.float32(drop_probability))


def pool_branch_draw(seed: int, step: int, pool_size: int, periodic: bool) -> int:
    """Pool index in effect at ``step``: ``step % pool_size`` for a
    periodic schedule, else an i.i.d. draw in ``[0, pool_size)`` from the
    pool-branch threefry stream (tag 2), as the reference draws it."""
    step = int(step)
    if not -(2**31) <= step < 2**31:
        raise ValueError(f"step {step} does not fit int32")
    if periodic or pool_size <= 1:
        return step % pool_size
    return prng.randint(
        _pair_key(seed, step, 0, _tags.TAG_POOL_BRANCH), 0, pool_size
    )


def is_involution(perm: np.ndarray) -> bool:
    """True iff perm is a valid pairing: perm[perm[i]] == i for all i."""
    idx = np.arange(len(perm))
    return bool(np.all(perm[perm] == idx))


def _ring_even(n: int) -> np.ndarray:
    """Pair (0,1),(2,3),...  Last element self-pairs when n is odd."""
    perm = np.arange(n)
    for i in range(0, n - 1, 2):
        perm[i], perm[i + 1] = i + 1, i
    return perm


def _ring_odd(n: int) -> np.ndarray:
    """Pair (1,2),(3,4),... and close the ring with (n-1, 0) when n is even.

    n == 2 keeps the single pair active in both phases — a 2-node ring has
    only one edge."""
    if n == 2:
        return np.array([1, 0])
    perm = np.arange(n)
    for i in range(1, n - 1, 2):
        perm[i], perm[i + 1] = i + 1, i
    if n % 2 == 0:
        perm[n - 1], perm[0] = 0, n - 1
    return perm


def _random_matching(n: int, rng: np.random.Generator) -> np.ndarray:
    """A uniform random perfect matching (odd one out self-pairs)."""
    order = rng.permutation(n)
    perm = np.arange(n)
    for i in range(0, n - 1, 2):
        a, b = order[i], order[i + 1]
        perm[a], perm[b] = b, a
    return perm


def _ring_pull(n: int, phase: int) -> np.ndarray:
    """Directed ring pull map: peer i pulls from its ±1 neighbor."""
    return (np.arange(n) + (1 if phase % 2 == 0 else -1)) % n


def _exponential_pool(n: int) -> np.ndarray:
    """Hypercube (recursive-doubling) pool: slot k pairs ``i ↔ i XOR 2^k``.
    With α = 0.5 and full participation one pass over the log2(n) slots is
    an exact all-reduce.  Requires n a power of two, n >= 2."""
    if n < 2 or n & (n - 1) != 0:
        raise ValueError(
            f"exponential schedule needs a power-of-two peer count >= 2, got {n}"
        )
    bits = n.bit_length() - 1
    idx = np.arange(n)
    return np.stack([idx ^ (1 << k) for k in range(bits)])


def _random_pull(n: int, rng: np.random.Generator) -> np.ndarray:
    """Random pull map: every peer pulls a distinct source != itself
    (Sattolo's algorithm — a uniform random cyclic permutation)."""
    src = np.arange(n)
    for i in range(n - 1, 0, -1):
        j = rng.integers(0, i)
        src[i], src[j] = src[j], src[i]
    return src


def _check_groups(n: int, group_size: int, inter_period: int) -> int:
    if n % group_size != 0:
        raise ValueError(f"n_peers {n} not divisible by group_size {group_size}")
    if inter_period < 1:
        raise ValueError(f"inter_period must be >= 1, got {inter_period}")
    n_groups = n // group_size
    if inter_period == 1 and group_size > 1 and n_groups > 1:
        # An all-inter pool never mixes across intra-group indices.
        raise ValueError(
            "hierarchical schedule with inter_period=1 has no intra-group "
            "slots, so the gossip graph is disconnected for group_size >= 2; "
            "use inter_period >= 2"
        )
    return n_groups


def _hierarchical_pull_pool(
    n: int, group_size: int, inter_period: int
) -> np.ndarray:
    """Pull-mode two-level pool: directed intra-group ring rotations, with
    every ``inter_period``-th slot pulling from the same index in the next
    group (groups in a directed ring)."""
    n_groups = _check_groups(n, group_size, inter_period)
    pool = []
    for slot in range(inter_period):
        if slot == inter_period - 1 and n_groups > 1:
            src = np.arange(n)
            for g in range(n_groups):
                pg = (g + 1) % n_groups
                src[g * group_size : (g + 1) * group_size] = (
                    np.arange(group_size) + pg * group_size
                )
            pool.append(src)
        else:
            base = _ring_pull(group_size, slot)
            pool.append(
                np.concatenate([base + g * group_size for g in range(n_groups)])
            )
    return np.stack(pool)


def _group_round_robin(n_groups: int) -> list[np.ndarray]:
    """Round-robin tournament (circle method) over groups: group-level
    involutions that together visit every unordered group pair."""
    if n_groups == 1:
        return [np.array([0])]
    m = n_groups if n_groups % 2 == 0 else n_groups + 1  # m-1 = bye dummy
    arr = list(range(m))
    rounds = []
    for _ in range(m - 1):
        gperm = np.arange(n_groups)
        for i in range(m // 2):
            a, b = arr[i], arr[m - 1 - i]
            if a < n_groups and b < n_groups:  # skip the odd-count dummy
                gperm[a], gperm[b] = b, a
        rounds.append(gperm)
        arr = [arr[0], arr[-1]] + arr[1:-1]
    return rounds


def _hierarchical_pool(
    n: int, group_size: int, inter_period: int
) -> np.ndarray:
    """Two-level pool: intra-group ring pairings, with every
    ``inter_period``-th slot exchanging across groups along a round-robin
    tournament over groups; the intra slots alternate the two ring phases
    on a global intra-slot counter."""
    n_groups = _check_groups(n, group_size, inter_period)
    rounds = _group_round_robin(n_groups) if n_groups > 1 else [None]
    n_blocks = len(rounds)
    # Both intra ring phases must appear (needed to connect groups > 2).
    if group_size > 2 and n_blocks * (inter_period - 1) < 2:
        rounds = rounds * 2
        n_blocks *= 2
    pool = []
    intra_count = 0
    for block in range(n_blocks):
        for slot in range(inter_period):
            if slot == inter_period - 1 and n_groups > 1:
                gperm = rounds[block]
                perm = np.arange(n)
                for g in range(n_groups):
                    pg = gperm[g]
                    perm[g * group_size : (g + 1) * group_size] = (
                        np.arange(group_size) + pg * group_size
                    )
                pool.append(perm)
            else:
                base = (
                    _ring_even if intra_count % 2 == 0 else _ring_odd
                )(group_size)
                intra_count += 1
                pool.append(
                    np.concatenate(
                        [base + g * group_size for g in range(n_groups)]
                    )
                )
    return np.stack(pool)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A compiled-pool gossip schedule.

    Attributes:
      pool: [K, n] int32 — K static pairings (pairwise) or pull maps (pull).
      n_peers: stacked-axis size (length of the YAML ``nodes:`` list).
      fetch_probability: per-step chance that a pair exchanges.
      seed: RNG seed of the participation draws (and of a random pool).
      branch_map: optional [period] map from step-in-period to pool row
        (the hierarchical pool is deduplicated); None is the identity.
    """

    pool: np.ndarray
    n_peers: int
    fetch_probability: float
    seed: int
    name: str
    drop_probability: float = 0.0
    mode: str = "pairwise"  # pairwise (involutions) | pull (one-sided maps)
    wire_dtype: str = "f32"  # precision of the shipped replica (f32 | bf16 | int8)
    branch_map: Optional[np.ndarray] = None

    @property
    def pool_size(self) -> int:
        return len(self.pool)

    @property
    def period(self) -> int:
        """Length of the schedule's repeating cycle in steps."""
        return len(self.branch_map) if self.branch_map is not None else len(self.pool)

    @property
    def periodic(self) -> bool:
        """Whether pool selection cycles (ring/hierarchical/exponential) or
        is drawn per step (random)."""
        return self.name != "random"

    def branch(self, step: int) -> int:
        """Pool row in effect at ``step`` (cyclic, or the random schedule's
        per-step threefry draw)."""
        idx = pool_branch_draw(self.seed, step, self.period, self.periodic)
        return int(self.branch_map[idx]) if self.branch_map is not None else idx

    def pair_id(self, i: int, partner: int):
        """The key a peer's participation draw would be folded on:
        ``min(i, partner)`` pairwise (one draw per pair), ``i`` in pull
        mode (the puller draws alone)."""
        return i if self.mode == "pull" else min(i, partner)

    def pairing(self, step: int) -> np.ndarray:
        """The pairing (pairwise) or pull map (pull) in effect at ``step``."""
        return self.pool[self.branch(step)]

    def partner(self, step: int, i: int) -> int:
        return int(self.pairing(step)[i])

    @property
    def draws(self) -> bool:
        """Whether a round draws its participation (``fetch_probability <
        1``) or faults (``drop_probability > 0``)."""
        return self.fetch_probability < 1.0 or self.drop_probability > 0.0

    def keeps(self, step: int, pair_id: int) -> bool:
        """Whether pair ``pair_id``'s exchange goes ahead at ``step``: its
        participation draw passed and its fault draw did not."""
        ok = self.fetch_probability >= 1.0 or participation_draw(
            self.seed, step, pair_id, self.fetch_probability
        )
        if ok and self.drop_probability > 0.0:
            ok = not fault_draw(self.seed, step, pair_id, self.drop_probability)
        return ok

    def drawn(self, step: int, partner) -> np.ndarray:
        """bool ``[n]``: :meth:`keeps` for each peer's pair under the
        round's ``partner`` map, one draw per pair id (a self-pair is
        masked by the caller, as the reference masks it)."""
        memo: dict[int, bool] = {}
        out = np.empty(len(partner), dtype=bool)
        for i, p in enumerate(partner):
            pid = self.pair_id(i, int(p))
            if pid not in memo:
                memo[pid] = self.keeps(step, pid)
            out[i] = memo[pid]
        return out

    def participates(self, step: int, i: int) -> bool:
        """Whether peer ``i`` exchanges at ``step``: it is paired and its
        pair :meth:`keeps` the round."""
        p = self.partner(step, i)
        return p != i and self.keeps(step, self.pair_id(i, p))


def build_schedule(config: DpwaConfig) -> Schedule:
    """Materialize the pairing/pull pool described by ``config.protocol``."""
    proto = config.protocol
    n = config.n_peers
    pull = proto.mode == "pull"
    if n == 1:
        pool = np.zeros((1, 1), dtype=np.int64)
    elif pull:
        if proto.schedule == "ring":
            pool = np.stack([_ring_pull(n, 0), _ring_pull(n, 1)])
        elif proto.schedule == "random":
            rng = np.random.default_rng(proto.seed)
            pool = np.stack(
                [_random_pull(n, rng) for _ in range(proto.resolved_pool_size(n))]
            )
        elif proto.schedule == "hierarchical":
            group = proto.group_size or _auto_group_size(n)
            pool = _hierarchical_pull_pool(n, group, proto.inter_period)
        elif proto.schedule == "exponential":
            # XOR pairings are their own pull maps: the same pool in both
            # modes; only the participation keying differs.
            pool = _exponential_pool(n)
        else:  # pragma: no cover - config validates earlier
            raise ValueError(proto.schedule)
    elif proto.schedule == "ring":
        pool = np.stack([_ring_even(n), _ring_odd(n)])
    elif proto.schedule == "random":
        rng = np.random.default_rng(proto.seed)
        pool = np.stack(
            [_random_matching(n, rng) for _ in range(proto.resolved_pool_size(n))]
        )
    elif proto.schedule == "hierarchical":
        group = proto.group_size or _auto_group_size(n)
        pool = _hierarchical_pool(n, group, proto.inter_period)
    elif proto.schedule == "exponential":
        pool = _exponential_pool(n)
    else:  # pragma: no cover - config validates earlier
        raise ValueError(proto.schedule)
    pool = pool.astype(np.int32)
    branch_map = None
    if not pull and proto.schedule == "hierarchical" and len(pool) > 1:
        # Dedupe repeated slots (the intra ring phases recur every block):
        # pool keeps only distinct pairings, branch_map restores the cycle.
        pool, inverse = np.unique(pool, axis=0, return_inverse=True)
        branch_map = inverse.astype(np.int32).reshape(-1)
    for k, perm in enumerate(pool):
        if pull:
            if sorted(perm) != list(range(n)):
                raise AssertionError(f"pull map not a permutation at slot {k}")
            if n > 1 and np.any(perm == np.arange(n)):
                raise AssertionError(f"pull map has self-pull at slot {k}")
        elif not is_involution(perm):
            raise AssertionError(f"schedule produced non-involution at slot {k}")
    return Schedule(
        pool=pool,
        n_peers=n,
        fetch_probability=proto.fetch_probability,
        seed=proto.seed,
        name=proto.schedule,
        drop_probability=proto.drop_probability,
        mode=proto.mode,
        wire_dtype=proto.wire_dtype,
        branch_map=branch_map,
    )


def _auto_group_size(n: int) -> int:
    """Default hierarchical group: 4 peers per group when divisible, else
    8 or 2, else the whole ring."""
    for g in (4, 8, 2):
        if n % g == 0 and n // g > 1:
            return g
    return n
