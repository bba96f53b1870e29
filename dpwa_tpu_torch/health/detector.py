"""Fetch outcome classes, as the reference's fetcher reports them.

The port's copy of :class:`dpwa_tpu.health.detector.Outcome`: the same
strings, so a port node's ``last_fetch`` and ``last_round`` read as a
reference node's.  The failure detector and scoreboard that feed on them
are not ported yet.
"""

from __future__ import annotations


class Outcome:
    """Fetch outcome classes (plain strings, so they serialise as they are)."""

    SUCCESS = "success"
    TIMEOUT = "timeout"  # the cumulative deadline lapsed with nothing received
    REFUSED = "refused"  # the connect failed: nothing listening
    SHORT_READ = "short_read"  # the peer closed or reset mid-frame
    CORRUPT = "corrupt"  # bad magic, version or code, oversize, undecodable
    POISONED = "poisoned"  # a well-formed frame the recovery guard rejected
    UNTRUSTED = "untrusted"  # rejected by trust screening (not ported yet)
    BUSY = "busy"  # the peer shed the request with a BUSY frame
    SLOW = "slow"  # the deadline lapsed while bytes were still flowing
    STALE = "stale"  # an async round's frame too old to merge (not ported yet)

    FAILURES = (
        TIMEOUT, REFUSED, SHORT_READ, CORRUPT, POISONED, UNTRUSTED,
        BUSY, SLOW, STALE,
    )
    ALL = (SUCCESS,) + FAILURES
