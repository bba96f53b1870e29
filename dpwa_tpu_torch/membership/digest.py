"""Compact versioned membership digest — the epidemic payload (the port's
copy of :mod:`dpwa_tpu.membership.digest`, byte for byte its encoder,
decoder and merge rules; ``tests/test_torch_membership.py`` holds them
against it).

SWIM-style dissemination (cf. the Prime collective-communications design,
PAPERS.md): every gossip frame carries the sender's current view of every
peer as a fixed-width trailing section, and receivers fold it into their
own view.  The digest is deliberately tiny — 11 bytes per peer — so
piggybacking it on every exchange costs nothing next to the replica
payload, which is the whole point of epidemic dissemination: membership
information spreads at the gossip fan-out rate with zero extra
connections.

Wire layout (append-only versioned)::

    DPWM | u8 version | u16 origin | u32 origin_round | u16 n_entries
    then n_entries ×:
    v1: u16 peer | u8 state | u32 incarnation | f32 suspicion
    v2: v1 fields | u16 island | u16 leader_term | u8 flags

Version 2 is the hierarchical-gossip digest (docs/hierarchy.md): each
entry additionally names the island the peer belongs to, the island's
current leadership term, and (flags bit0) whether the peer is the
island's elected leader.  Flat rings keep encoding version 1
byte-identically; v2 appears only when a ``topology:`` block is
configured.  A v1-only reader rejects the unknown version and reads no
trailer — safe, because the digest is optional by contract.

States are severity-ordered so "more damning wins" is an integer
comparison.  ``dead`` is a gossip label (give up remapping to this peer),
not a tombstone — the origin keeps probing and will disseminate ``alive``
again if the peer returns.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

# Magic and layouts come from the port's copy of the wire constants.
from dpwa_tpu_torch.parallel import protocol_constants as _pc

DIGEST_MAGIC = _pc.DIGEST_MAGIC
DIGEST_VERSION = 1
# Hierarchical (island-aware) digest version — wider entries, same header.
DIGEST_VERSION_HIER = 2

# Wire sentinel for "no island": flat v1 entries decode to this, and a
# v2 encoder uses it for peers whose island is unknown.  u16 max so real
# island ids 0..65534 stay representable.
NO_ISLAND = 0xFFFF

# Severity-ordered member states (merge rule: same incarnation -> the
# numerically larger state wins).
ALIVE = 0
SUSPECT = 1
QUARANTINED = 2
DEAD = 3

STATE_NAMES = ("alive", "suspect", "quarantined", "dead")

_DIGEST_HDR = _pc.DIGEST_HDR  # magic, version, origin, round, n
_ENTRY = _pc.DIGEST_ENTRY  # peer, state, incarnation, suspicion
_ENTRY_V2 = _pc.DIGEST_ENTRY_V2  # + island, leader_term, flags
_ENTRY_SIZES = {DIGEST_VERSION: _ENTRY.size, DIGEST_VERSION_HIER: _ENTRY_V2.size}
_LEADER_FLAG = 0x01  # flags bit0 of a v2 entry

# Upper bound a receiver will buffer for one digest body; far above any
# real ring (65535 peers × 11 B ≈ 700 KiB) but finite, so a corrupt
# length field cannot make the reader allocate unboundedly.
MAX_DIGEST_BYTES = _pc.MAX_DIGEST_BYTES

# Wire-reader helpers (dpwa_tpu_torch/parallel/tcp.py): the trailing-section
# read is two-phase — fixed header first, then the entry block the
# header's count implies.
HEADER_SIZE = _DIGEST_HDR.size


def header_entry_count(header: bytes) -> Optional[int]:
    """Entry count from a digest header, or None when the bytes are not
    a digest (wrong magic/version/length) — the old-peer/no-digest case."""
    if len(header) != _DIGEST_HDR.size:
        return None
    magic, version, _origin, _rnd, n = _DIGEST_HDR.unpack(header)
    if magic != DIGEST_MAGIC or version not in _ENTRY_SIZES:
        return None
    if n * _ENTRY_SIZES[version] > MAX_DIGEST_BYTES:
        return None
    return int(n)


def header_entries_nbytes(header: bytes) -> Optional[int]:
    """Total byte size of the entry block a digest header implies, sized
    per the header's version (v1: 11 B/entry, v2: 16 B/entry); None when
    the header is not a known digest.  This is what the wire reader's
    second-phase read must use — ``entries_size`` assumes v1."""
    if len(header) != _DIGEST_HDR.size:
        return None
    magic, version, _origin, _rnd, n = _DIGEST_HDR.unpack(header)
    if magic != DIGEST_MAGIC or version not in _ENTRY_SIZES:
        return None
    nbytes = int(n) * _ENTRY_SIZES[version]
    if nbytes > MAX_DIGEST_BYTES:
        return None
    return nbytes


def entries_size(n_entries: int) -> int:
    return int(n_entries) * _ENTRY.size


@dataclasses.dataclass
class MemberEntry:
    """One peer's disseminated state."""

    state: int = ALIVE
    incarnation: int = 0
    suspicion: float = 0.0
    # Hierarchical (v2) fields; flat v1 entries keep the defaults.
    island: int = NO_ISLAND
    leader_term: int = 0
    is_leader: bool = False

    @property
    def state_name(self) -> str:
        return STATE_NAMES[self.state]


@dataclasses.dataclass
class Digest:
    """A decoded membership digest: who said what, as of which round."""

    origin: int
    round: int
    entries: Dict[int, MemberEntry]
    version: int = DIGEST_VERSION

    def items(self) -> Iterator[Tuple[int, MemberEntry]]:
        # Sorted so consumers that fold entries into decisions see the
        # same order on every node regardless of decode insertion order.
        return iter(sorted(self.entries.items()))


def encode_digest(digest: Digest) -> bytes:
    """Serialize to the trailing-section wire form (header + entries).

    The digest's ``version`` field picks the entry layout: v1 (flat) is
    byte-identical to the pre-hierarchy encoder, v2 appends the island /
    leader-term / leader-flag fields to every entry."""
    hier = digest.version == DIGEST_VERSION_HIER
    entries = sorted(digest.entries.items())
    parts = [
        _DIGEST_HDR.pack(
            DIGEST_MAGIC,
            DIGEST_VERSION_HIER if hier else DIGEST_VERSION,
            digest.origin & 0xFFFF,
            digest.round & 0xFFFFFFFF,
            len(entries),
        )
    ]
    for peer, e in entries:
        if hier:
            parts.append(
                _ENTRY_V2.pack(
                    peer & 0xFFFF,
                    e.state & 0xFF,
                    e.incarnation & 0xFFFFFFFF,
                    float(e.suspicion),
                    e.island & 0xFFFF,
                    e.leader_term & 0xFFFF,
                    _LEADER_FLAG if e.is_leader else 0,
                )
            )
        else:
            parts.append(
                _ENTRY.pack(
                    peer & 0xFFFF,
                    e.state & 0xFF,
                    e.incarnation & 0xFFFFFFFF,
                    float(e.suspicion),
                )
            )
    return b"".join(parts)


def decode_digest(blob: bytes) -> Optional[Digest]:
    """Parse a digest blob; None for anything malformed.

    Tolerant by design: the digest rides as an OPTIONAL trailing section
    after the replica payload, and an old-format peer (or a chaos-
    truncated frame) simply has no valid digest there — that must never
    fail the exchange, so every malformation maps to None rather than an
    exception.  Unknown FUTURE versions also return None (entry width
    may differ); version bumps that keep the layout should append, not
    reshape."""
    if len(blob) < _DIGEST_HDR.size or len(blob) > MAX_DIGEST_BYTES:
        return None
    magic, version, origin, rnd, n = _DIGEST_HDR.unpack_from(blob, 0)
    if magic != DIGEST_MAGIC or version not in _ENTRY_SIZES:
        return None
    entry = _ENTRY_V2 if version == DIGEST_VERSION_HIER else _ENTRY
    need = _DIGEST_HDR.size + n * entry.size
    if len(blob) < need:
        return None
    entries: Dict[int, MemberEntry] = {}
    off = _DIGEST_HDR.size
    for _ in range(n):
        if version == DIGEST_VERSION_HIER:
            (
                peer, state, incarnation, suspicion,
                island, leader_term, flags,
            ) = entry.unpack_from(blob, off)
        else:
            peer, state, incarnation, suspicion = entry.unpack_from(blob, off)
            island, leader_term, flags = NO_ISLAND, 0, 0
        off += entry.size
        if state > DEAD:
            return None
        entries[int(peer)] = MemberEntry(
            state=int(state),
            incarnation=int(incarnation),
            suspicion=float(suspicion),
            island=int(island),
            leader_term=int(leader_term),
            is_leader=bool(flags & _LEADER_FLAG),
        )
    return Digest(
        origin=int(origin), round=int(rnd), entries=entries,
        version=int(version),
    )


def merge_entry(
    local: MemberEntry, claim: MemberEntry
) -> Tuple[MemberEntry, bool]:
    """Fold one remote claim into a local view entry.

    Incarnation-based conflict resolution (the SWIM rule set):

    - a higher incarnation always wins outright — the subject itself is
      the only writer of its incarnation, so a bigger number is strictly
      fresher information;
    - at equal incarnations the more-damning state wins and suspicion
      takes the max (failure evidence accumulates, it never un-happens
      without a refutation);
    - a lower incarnation is stale noise and is dropped.

    The hierarchical (v2) fields ride the same rules: a winning claim
    carries its island/leader view along; at equal incarnations the
    HIGHER leader term is fresher (terms only ever increase — the
    island's leader board is the sole writer), and a known island id
    beats the ``NO_ISLAND`` sentinel a flat v1 claim decodes to.

    Returns ``(merged, changed)``."""
    if claim.incarnation > local.incarnation:
        return (
            MemberEntry(
                state=claim.state,
                incarnation=claim.incarnation,
                suspicion=claim.suspicion,
                island=claim.island,
                leader_term=claim.leader_term,
                is_leader=claim.is_leader,
            ),
            True,
        )
    if claim.incarnation < local.incarnation:
        return local, False
    state = max(local.state, claim.state)
    suspicion = max(local.suspicion, claim.suspicion)
    island = local.island if local.island != NO_ISLAND else claim.island
    if claim.leader_term > local.leader_term:
        leader_term, is_leader = claim.leader_term, claim.is_leader
    else:
        leader_term, is_leader = local.leader_term, local.is_leader
    changed = (
        state != local.state
        or suspicion != local.suspicion
        or island != local.island
        or leader_term != local.leader_term
        or is_leader != local.is_leader
    )
    if changed:
        return (
            MemberEntry(
                state=state,
                incarnation=local.incarnation,
                suspicion=suspicion,
                island=island,
                leader_term=leader_term,
                is_leader=is_leader,
            ),
            True,
        )
    return local, False
