"""Structured per-step metrics as JSONL (the port of :mod:`dpwa_tpu.metrics`).

One JSON object a record (loss, exchange partner, α, participation, bytes
moved, timings, health columns, events), to a file and/or a stream: the
records the reference writes, key for key and byte for byte apart from the
``t`` stamps.  Tensors are read back to the host only when a deferred
record is written (:meth:`MetricsLogger.flush`)."""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import IO, Any, Mapping, Optional

import numpy as np
import torch


def _host(v: Any) -> np.ndarray:
    """``v`` as a host numpy array (a tensor is read back from its device)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _jsonable(v: Any) -> Any:
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, torch.Tensor):
        return _host(v).tolist()
    return v


class MetricsLogger:
    """Writes one JSON object a record.

    :meth:`log_exchange` is deferred: it holds its record until the next
    logging point, so the last record of a run is written by :meth:`flush`
    / :meth:`close` (or the ``atexit`` flush registered as a safety net).
    Every logging point first writes the pending record, so records land in
    the order they were made, with their own ``step`` and ``t``.

    ``max_bytes`` caps the file: when the next record would push it past
    the cap, ``<path>`` rolls into the ``<path>.1`` … ``<path>.keep``
    cascade (``.i`` moves to ``.i+1``, the oldest is replaced) and a fresh
    file starts; 0 is unbounded."""

    def __init__(
        self,
        path: Optional[str] = None,
        stream: Optional[IO[str]] = None,
        every: int = 1,
        max_bytes: int = 0,
        keep: int = 1,
    ):
        self._path = path
        self._file = open(path, "a", encoding="utf-8") if path else None
        self._stream = stream
        self.every = max(1, every)
        self.max_bytes = max(0, int(max_bytes))
        self.keep = max(1, int(keep))
        self._t0 = time.perf_counter()
        self._pending = None
        # Guards the hand-off of the deferred record: any logging point,
        # from any thread, may pop it, and only one may write it.  Apart
        # from _write_lock, since flush() re-enters log() -> _write().
        self._pending_lock = threading.Lock()
        # Serialises writers, so concurrent loggers never tear a line or
        # roll twice.
        self._write_lock = threading.Lock()
        atexit.register(self.flush)

    def _rotate(self) -> None:
        """Roll ``<path>`` into the cascade (``_write_lock`` held)."""
        try:
            self._file.close()
            for i in range(self.keep - 1, 0, -1):
                older = f"{self._path}.{i}"
                if os.path.exists(older):
                    os.replace(older, f"{self._path}.{i + 1}")
            os.replace(self._path, self._path + ".1")
        except OSError:
            pass
        self._file = open(self._path, "a", encoding="utf-8")

    def _write(self, line: str) -> None:
        with self._write_lock:
            if self._file is not None:
                if self.max_bytes and self._path:
                    try:
                        pos = self._file.tell()
                    except OSError:
                        pos = 0
                    if pos and pos + len(line) + 1 > self.max_bytes:
                        self._rotate()
                self._file.write(line + "\n")
                self._file.flush()
            if self._stream is not None:
                print(line, file=self._stream, flush=True)

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _stamp(self, step: int, _t: Optional[float]) -> dict:
        return {
            "step": int(step),
            "t": round((time.perf_counter() - self._t0) if _t is None else _t, 4),
        }

    def log(self, step: int, _t: Optional[float] = None, **fields: Any) -> None:
        if step % self.every != 0:
            return
        # The deferred record of an earlier step lands first (flush pops it
        # before it re-enters log, so this never recurses).
        self.flush()
        rec = self._stamp(step, _t)
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        self._write(json.dumps(rec))

    def elapsed(self) -> float:
        """Seconds since this logger was made (the ``t`` clock)."""
        return time.perf_counter() - self._t0

    def log_exchange(
        self,
        step: int,
        losses,
        info,
        payload_bytes: int,
        t: Optional[float] = None,
        **extra: Any,
    ) -> None:
        """The stacked gossip round's record, deferred: ``losses`` and
        ``info`` (``partner``, ``alpha``, ``participated``) are not read
        until the next logging point, by when the device has long finished
        them.  ``t`` overrides the record's stamp on the :meth:`elapsed`
        clock."""
        if step % self.every != 0:
            return
        self.flush()
        with self._pending_lock:
            self._pending = (
                step,
                self.elapsed() if t is None else t,
                losses,
                info,
                payload_bytes,
                extra,
            )

    def log_health(self, step: int, snapshot: Mapping[str, Any], **extra: Any) -> None:
        """One health record from a
        :meth:`~dpwa_tpu_torch.parallel.tcp.TcpTransport.health_snapshot`:
        the per-peer dict flattened into lists aligned with ``peer``, and
        each plane's columns only when its sub-document is in the snapshot
        (the reference's ``log_health``, column for column).  Obeys
        ``every``; written at once."""
        if step % self.every != 0:
            return
        peers = snapshot.get("peers", {})
        order = sorted(peers)
        cols = lambda key: [peers[p].get(key) for p in order]  # noqa: E731
        membership = snapshot.get("membership")
        if membership is not None:
            extra = dict(
                extra,
                incarnation=cols("incarnation"),
                own_incarnation=membership.get("incarnation"),
                component=membership.get("component"),
                component_id=membership.get("component_id"),
                partition_state=membership.get("partition_state"),
            )
        if order and "trust" in peers[order[0]]:
            extra = dict(
                extra,
                trust=cols("trust"),
                trust_verdict=cols("trust_verdict"),
                trust_damped=cols("trust_damped"),
                trust_rejected=cols("trust_rejected"),
            )
        flowctl = snapshot.get("flowctl")
        if flowctl is not None and order:
            hedges = flowctl.get("hedges", 0)
            admission = flowctl.get("admission") or {}
            extra = dict(
                extra,
                deadline_ms=cols("deadline_ms"),
                hedges=cols("hedges"),
                hedge_wins=cols("hedge_wins"),
                busy=cols("busy"),
                slow=cols("slow"),
                hedge_rate=(
                    round(flowctl.get("hedge_wins", 0) / hedges, 4) if hedges else 0.0
                ),
                shed_total=admission.get("shed_total", 0),
            )
        wire = snapshot.get("wire")
        if wire is not None:
            extra = dict(
                extra,
                wire_codec=wire.get("codec"),
                wire_bytes=wire.get("wire_bytes"),
                compression_ratio=wire.get("compression_ratio"),
            )
            if wire.get("copies_per_frame") is not None:
                extra = dict(
                    extra,
                    copies_per_frame=wire.get("copies_per_frame"),
                    ring_occupancy=wire.get("ring_occupancy"),
                )
            overlap = wire.get("overlap")
            if overlap is not None:
                extra = dict(
                    extra,
                    overlap_occupancy=overlap.get("occupancy"),
                    overlap_hidden_frac=overlap.get("hidden_frac"),
                    overlap_prefetched=overlap.get("prefetched"),
                    overlap_straddled=overlap.get("straddled"),
                )
            device = wire.get("device")
            if device is not None and device.get("device_rounds"):
                extra = dict(
                    extra,
                    device_rounds=device.get("device_rounds"),
                    jit_cache_hits=device.get("jit_cache_hits"),
                    jit_cache_misses=device.get("jit_cache_misses"),
                    device_dispatches_per_round=device.get("device_dispatches_per_round"),
                    h2d_zero_copy_frac=device.get("h2d_zero_copy_frac"),
                    fold_frames=device.get("fold_frames"),
                )
            view = wire.get("view")
            if view is not None:
                extra = dict(
                    extra,
                    **{key: view.get(key) for key in (
                        "view_active", "view_passive", "view_tracked", "view_capped",
                        "view_digest_entries", "view_digest_bytes", "view_evicted_dead",
                        "view_evicted_cap", "view_promotions", "view_shuffles",
                    )},
                )
            shard = wire.get("shard")
            if shard is not None:
                extra = dict(extra, shard_k=shard.get("k"), shard_coverage=shard.get("coverage"))
        reactor = snapshot.get("reactor")
        if reactor is not None:
            extra = dict(
                extra,
                reactor_loop_lag_ms=reactor.get("loop_lag_ms"),
                reactor_ready_depth=reactor.get("ready_depth"),
                reactor_open=reactor.get("open"),
                reactor_evicted=reactor.get("evicted"),
                reactor_busy_shed=reactor.get("busy_shed"),
            )
        obs = snapshot.get("obs")
        if obs is not None:
            conv = obs.get("convergence")
            if conv is not None:
                extra = dict(
                    extra,
                    disagreement_rms=conv.get("rms"),
                    disagreement_rel=conv.get("rel_rms"),
                    sketch_peers=conv.get("peers_seen"),
                )
        tune = snapshot.get("tune")
        if tune is not None and order:
            links = tune.get("links") or {}
            tcol = lambda key: [links.get(p, {}).get(key) for p in order]  # noqa: E731
            extra = dict(
                extra,
                tune_rung=tcol("effective_rung"),
                tune_codec=tcol("codec"),
                tune_shed=tcol("shed_active"),
                tune_escalations=tune.get("escalations"),
                tune_backoffs=tune.get("backoffs"),
                tune_sheds=tune.get("sheds"),
                tune_dwell_violations=tune.get("dwell_violations"),
            )
        async_snap = snapshot.get("async")
        if async_snap is not None and order:
            apeers = async_snap.get("peers") or {}
            acol = lambda key, d: [apeers.get(p, {}).get(key, d) for p in order]  # noqa: E731
            extra = dict(
                extra,
                async_rounds=async_snap.get("rounds"),
                async_merges=async_snap.get("merges"),
                async_stale_drops=async_snap.get("stale_drops"),
                async_dup_drops=async_snap.get("dup_drops"),
                async_shed=async_snap.get("shed"),
                async_fold_frames=async_snap.get("fold_frames"),
                async_staleness_hist=async_snap.get("staleness_hist"),
                async_peer_merges=acol("merges", 0),
                async_peer_stale=acol("stale", 0),
                async_peer_pending=acol("pending", 0),
                async_peer_lag=acol("last_lag", None),
            )
        self.log(
            step,
            record="health",
            me=snapshot.get("me"),
            round=snapshot.get("round"),
            peer=[int(p) for p in order],
            peer_state=cols("state"),
            suspicion=cols("suspicion"),
            quarantined_rounds=cols("quarantined_rounds"),
            quarantines=cols("quarantines"),
            attempts=cols("attempts"),
            failures=cols("failures"),
            probe_attempts=cols("probe_attempts"),
            last_outcome=cols("last_outcome"),
            **extra,
        )

    def _log_now(self, step: int, head: dict, fields: Mapping[str, Any]) -> None:
        """A record that bypasses ``every``, written at once."""
        self.flush()
        rec = self._stamp(step, None)
        rec.update(head)
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        self._write(json.dumps(rec))

    def log_event(self, step: int, event: str, **fields: Any) -> None:
        """One ``record: "event"`` (a rollback, a bootstrap, a re-sync, a
        membership or trust event), written at once: events bypass
        ``every``."""
        self._log_now(step, {"record": "event", "event": str(event)}, fields)

    def log_tune(self, step: int, decision: Mapping[str, Any]) -> None:
        """One ``record: "tune"`` decision, written at once."""
        self._log_now(step, {"record": "tune"}, decision)

    def flush(self) -> None:
        """Write the deferred record, if any (reading its tensors back)."""
        with self._pending_lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        step, t, losses, info, payload_bytes, extra = pending
        alpha = _host(info.alpha)
        part = _host(info.participated)
        losses = _host(losses)
        self.log(
            step,
            _t=t,
            loss_mean=float(losses.mean()),
            losses=losses,
            partner=_host(info.partner),
            alpha=alpha,
            participated=part,
            exchanged_bytes=int(payload_bytes * int(part.sum())),
            **extra,
        )

    def close(self) -> None:
        self.flush()
        atexit.unregister(self.flush)
        with self._write_lock:
            if self._file is not None:
                self._file.close()
                self._file = None
