"""Round-trace spans: where a round's wall time goes (the port of
:mod:`dpwa_tpu.obs.trace`, record for record).

A round trace is one flat JSONL record: stage name to accumulated seconds,
with the identifiers that join it across peers, written through the port's
:class:`~dpwa_tpu_torch.metrics.MetricsLogger`:

- ``{"record": "trace", "kind": "round", "me", "step", "trace_id",
  "remote_trace_id", "partner", "outcome", "stages": {...}, ...}``, one a
  traced exchange on the fetching node: ``trace_id`` the ID this node
  published this round (``"{me}:{seq}"``), ``remote_trace_id`` the one the
  fetched frame carried;
- ``{"record": "trace", "kind": "serve", "me", "trace_id", "nbytes",
  "dur_s"}``, one a served frame on the serving node.

``tools/trace_report.py`` joins ``round.remote_trace_id`` to the partner's
``serve.trace_id``.  ``begin_round`` makes one dict a traced round,
``mark``/``set`` change it in place and nothing is formatted before
``end_round``; with no round active every hook is a no-op, and the
transport makes no timing call unless the tracer exists.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

from dpwa_tpu_torch.metrics import MetricsLogger

# The per-stage windows behind stage_summary()'s medians.
_STAGE_WINDOW = 512


class Tracer:
    """A node's round tracer.  ``begin_round``/``mark``/``set``/
    ``end_round`` run on the training thread, ``note_serve`` on Rx threads,
    the summaries on healthz and metrics threads: what they share is under
    one lock, and the current round's dict is the training thread's."""

    def __init__(self, me: int, every: int = 1, path: Optional[str] = None,
                 max_records: int = 4096):
        self.me = int(me)
        self.every = max(1, int(every))
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=max(1, int(max_records)))
        self._stage_win: Dict[str, deque] = {}
        self._stage_n: Dict[str, int] = {}
        self._stage_total: Dict[str, float] = {}
        self._cur: Optional[dict] = None
        self._pending_serve: deque = deque(maxlen=4096)
        self._logger = MetricsLogger(path=path) if path else None

    # -- the round (training thread) ------------------------------------
    @property
    def active(self) -> bool:
        return self._cur is not None

    def begin_round(self, step: int) -> bool:
        """Start tracing ``step`` (one round in ``every``)."""
        if step % self.every != 0:
            return False
        self._cur = {"record": "trace", "kind": "round", "me": self.me, "step": int(step),
                     "stages": {}}
        return True

    def mark(self, stage: str, dur_s: float) -> None:
        """Add ``dur_s`` to ``stage`` of the current round."""
        cur = self._cur
        if cur is None:
            return
        st = cur["stages"]
        st[stage] = st.get(stage, 0.0) + dur_s
        self._note_stage(stage, dur_s)

    def set(self, **fields: Any) -> None:
        """Attach identifier and outcome fields to the current round."""
        cur = self._cur
        if cur is None:
            return
        for k, v in fields.items():
            if v is not None:
                cur[k] = v

    def end_round(self, **fields: Any) -> None:
        cur, self._cur = self._cur, None
        if cur is None:
            return
        for k, v in fields.items():
            if v is not None:
                cur[k] = v
        cur["stages"] = {k: round(v, 6) for k, v in cur["stages"].items()}
        # The serve spans of this round land first: the file stays roughly
        # in time order.
        self._drain_serves()
        self._emit(cur)

    # -- the serve side (Rx threads) ------------------------------------
    def note_serve(self, trace_id: str, nbytes: int, dur_s: float) -> None:
        """One span a served frame.  Runs on an Rx thread while the fetcher
        is still receiving, so it only appends a tuple; the record is built
        when the training thread drains."""
        with self._lock:
            self._pending_serve.append((trace_id, int(nbytes), dur_s))

    def _drain_serves(self) -> None:
        with self._lock:
            if not self._pending_serve:
                return
            pending = list(self._pending_serve)
            self._pending_serve.clear()
        for trace_id, nbytes, dur_s in pending:
            self._note_stage("serve", dur_s)
            self._emit({"record": "trace", "kind": "serve", "me": self.me,
                        "trace_id": trace_id, "nbytes": nbytes, "dur_s": round(dur_s, 6)})

    # -- output ----------------------------------------------------------
    def _emit(self, rec: dict) -> None:
        with self._lock:
            self._records.append(rec)
            if self._logger is not None:
                # The logger's step: the round's, or the served frame's seq.
                step = rec.get("step")
                if step is None:
                    try:
                        step = int(str(rec.get("trace_id")).split(":")[1])
                    except (IndexError, ValueError):
                        step = 0
                self._logger.log(step, **{k: v for k, v in rec.items() if k != "step"})

    def _note_stage(self, stage: str, dur_s: float) -> None:
        with self._lock:
            win = self._stage_win.get(stage)
            if win is None:
                win = self._stage_win[stage] = deque(maxlen=_STAGE_WINDOW)
                self._stage_n[stage] = 0
                self._stage_total[stage] = 0.0
            win.append(dur_s)
            self._stage_n[stage] += 1
            self._stage_total[stage] += dur_s

    def pop_records(self) -> List[dict]:
        """Drain the records held in memory."""
        self._drain_serves()
        with self._lock:
            out = list(self._records)
            self._records.clear()
        return out

    def stage_summary(self) -> Dict[str, dict]:
        """Per stage ``{n, median_ms, mean_ms, total_s}`` over the recent
        window (the /metrics gauges)."""
        out: Dict[str, dict] = {}
        self._drain_serves()
        with self._lock:
            for stage in sorted(self._stage_win):
                vals = sorted(self._stage_win[stage])
                if not vals:
                    continue
                n = self._stage_n[stage]
                total = self._stage_total[stage]
                out[stage] = {
                    "n": n,
                    "median_ms": round(vals[len(vals) // 2] * 1e3, 4),
                    "mean_ms": round(total / n * 1e3, 4),
                    "total_s": round(total, 6),
                }
        return out

    def close(self) -> None:
        self._drain_serves()
        if self._logger is not None:
            self._logger.close()
            self._logger = None
