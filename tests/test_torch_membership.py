"""The port's membership plane against the reference's, on the CPU: the
digest and the manager.

Each test names the test of ``tests/test_membership.py`` it mirrors.
``tests/test_torch_membership_wire.py`` holds the wire and RELAY, and
``tests/test_torch_membership_partition.py`` the partition and heal.

- The digest: ``encode_digest``, ``decode_digest`` and ``merge_entry`` bit
  for bit on hypothesis-drawn entries (v1 and v2), the tolerant decoder on
  malformed blobs (``test_digest_roundtrip``, ``test_digest_decode_is_tolerant``,
  ``test_merge_entry_incarnation_rules``).
- The manager: seeded histories of fetch outcomes, probes, digest claims
  and round ends replayed on a port and a reference manager, each over its
  package's scoreboard: every encoded digest byte for byte, the events, the
  degraded flag, the heal advice, the view and the scoreboard snapshots
  (``test_refutation_bumps_own_incarnation``,
  ``test_quorum_degraded_mode_and_heal_advice``,
  ``test_dead_label_after_quarantine_streak``).
"""

import dataclasses
import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dpwa_tpu.config import MembershipConfig as RefMembershipConfig
from dpwa_tpu.health import scoreboard as ref_scoreboard
from dpwa_tpu.membership import digest as ref_digest
from dpwa_tpu.membership import manager as ref_manager
from dpwa_tpu.parallel import protocol_constants as ref_pc
from dpwa_tpu_torch.config import MembershipConfig
from dpwa_tpu_torch.health import Scoreboard
from dpwa_tpu_torch.membership import digest
from dpwa_tpu_torch.membership.manager import MembershipManager
from dpwa_tpu_torch.parallel import protocol_constants as pc
from dpwa_tpu_torch.parallel import tcp


# -- constants and the digest --------------------------------------------------

def test_relay_and_digest_constants_equal_reference():
    for name in ("RELAY_REQ", "RELAY_MAGIC", "DIGEST_MAGIC", "OBS_MAGIC", "RELAY_OUTCOME_NAMES",
                 "MAX_RELAY_TIMEOUT_MS", "MAX_DIGEST_BYTES", "MAX_SKETCH_VALUES",
                 "DIGEST_HDR_FMT", "DIGEST_ENTRY_FMT", "DIGEST_ENTRY_V2_FMT",
                 "RELAY_BODY_FMT", "RELAY_HDR_FMT"):
        assert getattr(pc, name) == getattr(ref_pc, name), name
    for name in ("RELAY_BODY", "RELAY_HDR", "DIGEST_HDR", "DIGEST_ENTRY", "DIGEST_ENTRY_V2",
                 "OBS_HDR"):
        assert getattr(pc, name).format == getattr(ref_pc, name).format, name
    assert tuple(tcp._RELAY_OUTCOMES) == ref_pc.RELAY_OUTCOME_NAMES
    assert (digest.HEADER_SIZE, digest.NO_ISLAND, digest.STATE_NAMES) == (
        ref_digest.HEADER_SIZE, ref_digest.NO_ISLAND, ref_digest.STATE_NAMES)


_u16 = st.integers(0, 0xFFFF)
_u32 = st.integers(0, 0xFFFFFFFF)
_entry = st.tuples(
    st.integers(0, 3), _u32, st.floats(width=32, allow_nan=False), _u16, _u16, st.booleans()
)


def _entries(module, raw):
    return {
        peer: module.MemberEntry(state=s, incarnation=inc, suspicion=su, island=isl,
                                 leader_term=term, is_leader=lead)
        for peer, (s, inc, su, isl, term, lead) in raw.items()
    }


@settings(max_examples=150, deadline=None)
@given(origin=_u16, rnd=_u32, version=st.sampled_from([1, 2]),
       raw=st.dictionaries(_u16, _entry, max_size=12))
def test_digest_encode_decode_bit_equal_to_reference(origin, rnd, version, raw):
    """Mirrors ``test_digest_roundtrip``."""
    mine = digest.encode_digest(digest.Digest(origin, rnd, _entries(digest, raw), version))
    theirs = ref_digest.encode_digest(
        ref_digest.Digest(origin, rnd, _entries(ref_digest, raw), version))
    assert mine == theirs
    got, want = digest.decode_digest(mine), ref_digest.decode_digest(mine)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert digest.header_entries_nbytes(mine[:digest.HEADER_SIZE]) == (
        ref_digest.header_entries_nbytes(mine[:digest.HEADER_SIZE]))


@settings(max_examples=200, deadline=None)
@given(blob=st.binary(max_size=80), cut=st.integers(0, 60))
def test_digest_decode_as_tolerant_as_reference(blob, cut):
    """Mirrors ``test_digest_decode_is_tolerant``: garbage, truncations and
    a real digest's prefixes decode alike (None, never a raise)."""
    real = ref_digest.encode_digest(ref_digest.Digest(1, 9, {
        0: ref_digest.MemberEntry(state=1, incarnation=3, suspicion=0.5),
        2: ref_digest.MemberEntry(state=4 if cut % 7 == 0 else 2, incarnation=1)}))
    for b in (blob, real[:cut], pc.DIGEST_MAGIC + blob, real + blob):
        got, want = digest.decode_digest(b), ref_digest.decode_digest(b)
        assert (None if got is None else dataclasses.asdict(got)) == (
            None if want is None else dataclasses.asdict(want))
        head = b[:digest.HEADER_SIZE]
        assert digest.header_entries_nbytes(head) == ref_digest.header_entries_nbytes(head)
        assert digest.header_entry_count(head) == ref_digest.header_entry_count(head)


@settings(max_examples=300, deadline=None)
@given(a=_entry, b=_entry)
def test_merge_entry_bit_equal_to_reference(a, b):
    """Mirrors ``test_merge_entry_incarnation_rules``."""
    mine = digest.merge_entry(*[digest.MemberEntry(*e) for e in (a, b)])
    theirs = ref_digest.merge_entry(*[ref_digest.MemberEntry(*e) for e in (a, b)])
    assert (dataclasses.asdict(mine[0]), mine[1]) == (dataclasses.asdict(theirs[0]), theirs[1])


# -- the manager over seeded histories ------------------------------------------

_OUTCOMES = ("success", "success", "success", "refused", "timeout", "short_read", "corrupt",
             "untrusted", "busy")


def _claims(rng, n, me):
    """A random digest blob claimed by a random peer."""
    origin = int(rng.integers(0, n))
    entries = {}
    for p in rng.choice(n, size=int(rng.integers(1, n + 1)), replace=False):
        entries[int(p)] = ref_digest.MemberEntry(
            state=int(rng.integers(0, 4)), incarnation=int(rng.integers(0, 3)),
            suspicion=float(np.float32(rng.random() * 3)))
    return ref_digest.encode_digest(ref_digest.Digest(origin, int(rng.integers(0, 50)), entries))


def _replay_managers(seed, n=5, rounds=60, **cfg):
    """The same history on both packages' manager + scoreboard; every
    observable after each operation."""
    me = seed % n
    rng = np.random.default_rng(seed)
    mine_sb, ref_sb = Scoreboard(n, me, seed=seed), ref_scoreboard.Scoreboard(n, me, seed=seed)
    mine = MembershipManager(n, me, mine_sb, MembershipConfig(**cfg), seed=seed)
    ref = ref_manager.MembershipManager(n, me, ref_sb, RefMembershipConfig(**cfg), seed=seed)
    seen = []
    for r in range(rounds):
        for _ in range(int(rng.integers(1, 4))):
            kind = rng.integers(0, 4)
            peer = int(rng.choice([p for p in range(n) if p != me]))
            if kind == 0:
                out = _OUTCOMES[int(rng.integers(0, len(_OUTCOMES)))]
                for sb in (mine_sb, ref_sb):
                    sb.record(peer, out, round=r)
            elif kind == 1:
                out = _OUTCOMES[int(rng.integers(0, 6))]
                for sb in (mine_sb, ref_sb):
                    sb.record_probe(peer, out, round=r)
            elif kind == 2:
                blob = _claims(rng, n, me)
                mine.merge(blob, round=r)
                ref.merge(blob, round=r)
            else:
                assert mine.encode(r) == ref.encode(r)
        mine.end_round(r)
        ref.end_round(r)
        seen.append((r, mine.encode(r) == ref.encode(r), mine.pop_events(), ref.pop_events(),
                     mine.pop_heal_advice(), ref.pop_heal_advice(), mine.degraded, ref.degraded,
                     mine.alpha_scale(), ref.alpha_scale(), mine.evicted_peers(),
                     ref.evicted_peers()))
    snaps = (json.dumps(mine_sb.snapshot(), sort_keys=True),
             json.dumps(ref_sb.snapshot(), sort_keys=True))
    return seen, snaps, mine, ref


def _strip_latency(snap):
    snap = json.loads(snap)
    for info in snap["peers"].values():
        for k in ("ewma_latency_ms", "ewma_throughput_mbps"):
            info.pop(k, None)
    return snap


@pytest.mark.parametrize("cfg", [
    {}, {"quorum_fraction": 0.75, "degraded_alpha_scale": 0.5},
    {"dead_after_quarantines": 1, "dead_gossip_rounds": 3, "reconcile_min_fraction": 0.1},
], ids=["defaults", "quorum", "evictions"])
@pytest.mark.parametrize("seed", range(4))
def test_manager_replays_reference_history(seed, cfg):
    """Mirrors ``test_refutation_bumps_own_incarnation``,
    ``test_quorum_degraded_mode_and_heal_advice`` and
    ``test_dead_label_after_quarantine_streak`` on seeded histories: every
    digest byte, event, heal advice, degraded flag, eviction, and the
    scoreboard's snapshot with the membership view in it."""
    seen, (mine_snap, ref_snap), mine, ref = _replay_managers(seed, **cfg)
    for r, same_digest, *pairs in seen:
        assert same_digest, r
        for a, b in zip(pairs[::2], pairs[1::2]):
            assert a == b, r
    assert _strip_latency(mine_snap) == _strip_latency(ref_snap)
    assert mine.view_snapshot() == ref.view_snapshot()
    kinds = {e["event"] for _, _, evs, *_ in seen for e in evs}
    assert {"refutation", "component_changed"} <= kinds


def test_scenarios_reach_every_decision():
    """The replays above exercise what they compare: across the seeds and
    configs some round is degraded, some leaves heal advice, some evicts."""
    found = set()
    for seed in range(4):
        for cfg in ({"quorum_fraction": 0.75}, {"dead_after_quarantines": 1,
                                                "dead_gossip_rounds": 3,
                                                "reconcile_min_fraction": 0.1}):
            seen, *_ = _replay_managers(seed, **cfg)
            for row in seen:
                found |= {"degraded"} if row[6] else set()
                found |= {"heal"} if row[4] else set()
                found |= {"evicted"} if row[10] else set()
    assert found == {"degraded", "heal", "evicted"}


def test_evicted_peer_returns_on_a_probe_as_reference():
    """Mirrors the eviction path of ``test_dead_label_after_quarantine_streak``:
    a peer held dead is evicted, and a successful probe brings it back
    through ``on_peer_returned``."""
    out = []
    for sb_cls, mgr_cls, cfg_cls in ((Scoreboard, MembershipManager, MembershipConfig),
                                     (ref_scoreboard.Scoreboard, ref_manager.MembershipManager,
                                      RefMembershipConfig)):
        sb = sb_cls(3, 0)
        mgr = mgr_cls(3, 0, sb, cfg_cls(dead_after_quarantines=1, dead_gossip_rounds=2))
        sb.adopt_quarantine(2, round=1)
        for r in range(1, 5):
            mgr.end_round(r)
        evicted = mgr.evicted_peers()
        probed = [r for r in range(5, 200) if sb.probe_due(2, r)][0]
        sb.record_probe(2, True, round=probed)
        mgr.end_round(probed)
        out.append((evicted, probed, mgr.pop_events(), mgr.evicted_peers(), sb.state(2),
                    mgr.encode(probed + 1)))
    assert out[0] == out[1]
    assert out[0][0] == [2] and out[0][3] == [] and out[0][4] == "healthy"
