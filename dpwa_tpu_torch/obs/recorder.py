"""The flight recorder: a bounded ring of per-round evidence (the port of
:mod:`dpwa_tpu.obs.recorder`, record for record).

The transport appends one compact entry a round (partner, outcome,
latency, codec, trust verdict, sketch disagreement, membership state, the
alerts that fired) to a ring of the last ``obs.recorder_rounds`` rounds,
and the ring is dumped to a JSONL file on a crash (:meth:`FlightRecorder.
arm_crash_dump`: an ``atexit`` hook and a SIGTERM handler, the handler only
from the main thread), on an incident's open, on a close and at the
``/flightdump`` route.  A dump is one ``record: "flight", kind: "meta"``
line (the reason and the ring's size) and the ring's entries as ``kind:
"round"`` lines in time order, written to a temporary file and renamed, so
a crash mid-dump leaves no torn file; every failure is swallowed.
``tools/incident_report.py`` joins the nodes' dumps.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import threading
import time
from collections import deque
from typing import Any, Dict, Optional


def default_path(me: int) -> str:
    return f"dpwa-flight-{me}.jsonl"


class FlightRecorder:
    """The ring and its crash-safe dumps.  ``note_round`` runs on the
    training thread; ``dump`` on it, a healthz thread, ``atexit`` or a
    signal handler, so it takes the lock and never raises."""

    def __init__(self, me: int, rounds: int = 64, path: Optional[str] = None):
        self.me = int(me)
        if path is None:
            path = default_path(self.me)
        else:
            try:
                path = path.format(me=self.me)
            except (KeyError, IndexError, ValueError):
                pass
        self.path = path
        self._ring: deque = deque(maxlen=max(1, int(rounds)))
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._dumps = 0
        self._armed = False
        self._prev_sigterm: Any = None

    def note_round(self, step: int, **fields: Any) -> None:
        """Append one round's evidence (JSON-ready values; None dropped)."""
        entry: Dict[str, Any] = {
            "record": "flight",
            "kind": "round",
            "me": self.me,
            "step": int(step),
            "t": round(time.perf_counter() - self._t0, 4),
        }
        for k, v in fields.items():
            if v is not None:
                entry[k] = v
        with self._lock:
            self._ring.append(entry)

    def dump(self, reason: str, step: Optional[int] = None) -> Optional[str]:
        """Write the meta line and the ring to :attr:`path`; the path, or
        None when the ring is empty or the write failed."""
        with self._lock:
            entries = list(self._ring)
            self._dumps += 1
            n_dump = self._dumps
        if not entries:
            return None
        meta: Dict[str, Any] = {
            "record": "flight",
            "kind": "meta",
            "me": self.me,
            "step": int(step) if step is not None else entries[-1]["step"],
            "t": round(time.perf_counter() - self._t0, 4),
            "reason": str(reason),
            "rounds": len(entries),
            "dumps": n_dump,
        }
        tmp = f"{self.path}.tmp.{os.getpid()}"

        def _coerce(v: Any) -> Any:
            # A stray numpy scalar must never abort a dump.
            try:
                return float(v)
            except (TypeError, ValueError):
                return str(v)

        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                for rec in (meta, *entries):
                    fh.write(json.dumps(rec, separators=(",", ":"), default=_coerce) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except (OSError, TypeError, ValueError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        return self.path

    def arm_crash_dump(self) -> None:
        """Register the ``atexit`` and SIGTERM dumps (once; the handler only
        where signals can be set: the main thread)."""
        if self._armed:
            return
        self._armed = True
        atexit.register(self._atexit_dump)
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, self._on_sigterm)
        except (ValueError, OSError):  # not the main thread
            self._prev_sigterm = None

    def _atexit_dump(self) -> None:
        if self._armed:
            self.dump("atexit")

    def _on_sigterm(self, signum, frame) -> None:
        self.dump("sigterm")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        else:
            # The default disposition back, and the signal again: the
            # process dies as SIGTERM says.
            try:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)
            except (ValueError, OSError):
                raise SystemExit(143)

    def disarm(self) -> None:
        """Drop the crash hooks (a clean close has dumped already)."""
        if not self._armed:
            return
        self._armed = False
        atexit.unregister(self._atexit_dump)
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
            self._prev_sigterm = None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "me": self.me,
                "path": self.path,
                "rounds": len(self._ring),
                "capacity": self._ring.maxlen,
                "dumps": self._dumps,
                "armed": self._armed,
            }
