"""Barrier-free async gossip rounds (the port of
:mod:`dpwa_tpu.parallel.async_loop`).

:class:`AsyncExchangeEngine` decouples the publish from the merge: partner
frames stream on background slots, land in bounded per-peer queues and
merge whenever they are ready, so a trickling straggler's fetch stays in
flight across rounds while every other peer keeps exchanging.

- **Staleness damping.**  A frame whose publish clock lags the local clock
  by ``L`` merges at ``α · staleness_damping ** L`` (in float64, rounded to
  float32 at the merge, as the reference's), on top of the trust damping
  the interpolation already applied.
- **Bounded staleness.**  ``lag > max_staleness`` drops the frame as the
  soft ``stale`` outcome: it degrades the peer, never quarantines it.
- **Deduplication.**  The transport's publish-clock guard
  (``TcpTransport._async_guard``, armed here) merges a publish clock at most
  once, whichever path delivered it.

Every decision (queue admission, the drop, the drain order, the fold runs)
is a function of publish clocks and the ``async_drain_draw`` stream (tag
33); wall time feeds only the tallies, through the injected ``now`` (the
flowctl estimator's clock, a :class:`~dpwa_tpu_torch.flowctl.vclock.
VirtualClock` in tests), so a scripted run (:meth:`offer`) repeats bit for
bit.

The slots move bytes only (:meth:`TcpTransport._wire_fetch` into the
receive ring); landing, the guard, the screen and the merge run on the
training thread at drain time, against the replica published in that
round.  The reference has two substrates that merge the same bits: a host
drain (its ``exchange``) and a device drain that folds runs of dense
frames.  The port runs the device drain, with B2's fold form on the card
(:func:`~dpwa_tpu_torch.device.engine.fold`), and makes the host drain's
decisions: it also records the partner's outcome in ``last_round``, as the
host drain does.  A frame held in a queue keeps its receive-ring lease
until it is merged, dropped or shed.  With ``obs.metrics`` the engine
registers its ``dpwa_async_*`` families (:func:`register_metrics`).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dpwa_tpu_torch.flowctl.vclock import monotonic_now
from dpwa_tpu_torch.health.detector import Outcome
from dpwa_tpu_torch.parallel.schedules import async_drain_draw
from dpwa_tpu_torch.parallel.tcp import _flat, _recycle_raw

__all__ = ["AsyncExchangeEngine"]

# The staleness histogram: a bucket per lag 0..max_staleness, then one
# counting the bounded-staleness drops.
_OVERFLOW = "overflow"


def _held_bytes(raw: tuple) -> int:
    """The receive-ring bytes a raw fetch holds (its leases' buffers)."""
    return sum(len(lease.view) for lease in raw[5])


class AsyncExchangeEngine:
    """Barrier-free round loop over a :class:`~dpwa_tpu_torch.parallel.tcp.
    TcpTransport`; constructing it wraps the transport (its
    ``async_engine``) and arms the transport's dedup guard.

    ``now`` is the tallies' clock: given, else the transport's flowctl
    estimator's, else the monotonic clock."""

    def __init__(self, transport, now: Optional[Callable[[], float]] = None):
        self.t = transport
        cfg = transport.config.protocol.async_rounds
        self.cfg = cfg
        self.me = transport.me
        self.seed = transport.schedule.seed
        if now is None:
            est = getattr(transport, "_estimator", None)
            now = est.now if est is not None else monotonic_now
        self.now: Callable[[], float] = now
        old = transport.async_engine
        if old is not None:
            old.release()
        transport._async_guard = {}
        transport.async_engine = self
        # Slot threads append arrivals; the training thread drains them.
        self._lock = threading.Lock()
        self._arrivals: List[tuple] = []  # (peer, raw, launch step, t_launch, t_land)
        self._inflight: Dict[int, dict] = {}
        # peer -> deque of (clock, raw, wire span, t_land), newest clocks kept.
        self._pending: Dict[int, deque] = {}
        self._round_stale: List[int] = []
        self._rounds = 0
        self._merges = 0
        self._stale_drops = 0
        self._dup_drops = 0
        self._shed = 0
        self._fold_dispatches = 0
        self._fold_frames = 0
        self._pending_wait_s = 0.0
        self._hist: Dict[object, int] = {
            **{lag: 0 for lag in range(int(cfg.max_staleness) + 1)}, _OVERFLOW: 0,
        }
        self._peer: Dict[int, dict] = {}
        # Receive-ring bytes held by queued frames (arrivals and pending).
        self._held = 0
        self._peak_held = 0
        if getattr(transport, "metrics_registry", None) is not None:
            register_metrics(transport.metrics_registry, self)

    # -- intake ---------------------------------------------------------
    def _peer_stats(self, peer: int) -> dict:
        s = self._peer.get(peer)
        if s is None:
            s = self._peer[peer] = {
                "merges": 0, "stale": 0, "shed": 0, "last_lag": None, "lag_sum": 0, "fails": 0,
            }
        return s

    def _hold(self, raw: tuple) -> None:
        with self._lock:
            self._held += _held_bytes(raw)
            self._peak_held = max(self._peak_held, self._held)

    def _drop(self, raw: tuple) -> None:
        """A queued frame leaves without a consume: its leases go back."""
        with self._lock:
            self._held -= _held_bytes(raw)
        _recycle_raw(raw)

    def _launch(self, peer: int, step: int) -> None:
        """Start a background wire fetch of ``peer`` unless one is in
        flight; the slot only moves bytes."""
        with self._lock:
            if peer in self._inflight:
                return
            slot = {"peer": peer, "step": int(step), "t0": self.now()}
            self._inflight[peer] = slot

        def run():
            raw = self.t._wire_fetch(peer, None, step)
            t1 = self.now()
            self._hold(raw)
            with self._lock:
                self._arrivals.append((peer, raw, step, slot["t0"], t1))
                self._inflight.pop(peer, None)

        th = threading.Thread(target=run, daemon=True, name=f"dpwa-torch-async:{self.t.port}")
        slot["thread"] = th
        th.start()

    def offer(self, peer: int, raw: tuple, step: int = 0, span_s: float = 0.0) -> None:
        """Hand the engine a raw fetch (:meth:`TcpTransport._wire_fetch`'s
        tuple): the scripted-arrival entry, in place of live slots."""
        t1 = self.now()
        self._hold(raw)
        with self._lock:
            self._arrivals.append((peer, raw, int(step), t1 - span_s, t1))

    def _collect(self, step: int) -> List[tuple]:
        """Move the arrivals into the pending queues: a failed fetch and a
        duplicate (a clock at or below the peer's last merged one) are
        returned to be charged this round; a full queue sheds its oldest
        publish clock."""
        with self._lock:
            arrivals, self._arrivals = self._arrivals, []
        charge: List[tuple] = []
        guard = self.t._async_guard or {}
        for peer, raw, _launch_step, t0, t1 in arrivals:
            got = raw[1]
            if got is None:
                charge.append((peer, raw, t1))
                continue
            clock = float(got[1])
            merged_ck = guard.get(int(raw[0]))
            if merged_ck is not None and clock <= merged_ck:
                with self._lock:
                    self._dup_drops += 1
                charge.append((peer, raw, t1))
                continue
            dq = self._pending.get(peer)
            if dq is None:
                dq = self._pending[peer] = deque()
            dq.append((clock, raw, max(t1 - t0, 0.0), t1))
            if len(dq) > int(self.cfg.queue_depth):
                oldest = min(range(len(dq)), key=lambda i: (dq[i][0], i))
                shed = dq[oldest][1]
                del dq[oldest]
                self._drop(shed)
                with self._lock:
                    self._shed += 1
                self._peer_stats(peer)["shed"] += 1
        return charge

    # -- drain and merge ------------------------------------------------
    def _drain_order(self, clock: float, step: int) -> List[tuple]:
        """The pending frames in drain order: lag ascending, equal lags
        ordered by ``async_drain_draw`` and then the peer, newer clocks
        first."""
        cands: List[tuple] = []
        for peer in sorted(self._pending):
            dq = self._pending[peer]
            while dq:
                ck, raw, span, t_land = dq.popleft()
                lag = max(int(clock) - int(ck), 0)
                draw = async_drain_draw(self.seed, step, peer)
                cands.append((lag, draw, peer, ck, raw, span, t_land))
        cands.sort(key=lambda c: (c[0], c[1], c[2], -c[3]))
        return cands

    def _charge_failures(self, charge: List[tuple], step: int, device) -> None:
        """Record failed and duplicate arrivals against this round: a failure
        through the consume half, a duplicate as ``stale``."""
        sb = self.t.scoreboard
        for _peer, raw, _t1 in charge:
            if raw[1] is None:  # a failed fetch holds no lease
                self.t._consume_fetch(raw, step, device)
                self._peer_stats(int(raw[0]))["fails"] += 1
            else:
                self._drop(raw)
                if sb is not None:
                    sb.record(int(raw[0]), Outcome.STALE, latency_s=float(raw[3]),
                              nbytes=int(raw[4]), round=step)

    def _drop_stale(self, peer: int, raw: tuple, lag: int, step: int) -> None:
        """The bounded-staleness drop: the soft ``stale`` outcome, counted in
        the overflow bucket; the frame is never landed."""
        self._drop(raw)
        with self._lock:
            self._stale_drops += 1
            self._hist[_OVERFLOW] += 1
        st = self._peer_stats(peer)
        st["stale"] += 1
        st["last_lag"] = int(lag)
        self._round_stale.append(peer)
        if self.t.scoreboard is not None:
            self.t.scoreboard.record(peer, Outcome.STALE, latency_s=float(raw[3]),
                                     nbytes=int(raw[4]), round=step)

    def _consume(self, raw: tuple, clock: float, loss: float, step: int, lag: int, device):
        """The transport's consume half on a pending frame, and its α damped
        by the lag: ``(landed frame, damped α, clock)`` or None when a screen
        (the guard, trust, the dedup) refused it."""
        with self._lock:
            self._held -= _held_bytes(raw)
        got = self.t._consume_fetch(raw, step, device)
        if got is None:
            return None
        alpha = self.t._weigh(got, clock, loss)
        damped = float(alpha) * float(self.cfg.staleness_damping) ** int(lag)
        return got[0], damped, got[1]

    def _note_merge(self, peer: int, lag: int, t_land: float) -> None:
        wait = max(self.now() - t_land, 0.0)
        with self._lock:
            self._merges += 1
            self._hist[int(lag)] = self._hist.get(int(lag), 0) + 1
            self._pending_wait_s += wait
        st = self._peer_stats(peer)
        st["merges"] += 1
        st["last_lag"] = int(lag)
        st["lag_sum"] += int(lag)

    def exchange_on_device(self, vec_dev: torch.Tensor, clock: float, loss: float, step: int):
        """One barrier-free round: publish, collect the arrivals, launch this
        round's partner fetch (unless one is in flight), then merge every
        pending frame that the drop rule keeps, in the drain order, each
        through the consume half; runs of dense frames fold into one launch
        (with ``async_rounds.fold``).  Never waits on a fetch.  Returns
        ``(merged, merges)``, ``merges`` the ``(peer, damped α, lag)``
        applied, in order; ``merged`` is ``vec_dev`` when none was."""
        t = self.t
        rep = t._replica(_flat(vec_dev))
        device = rep.dev.device
        try:
            t._publish_replica(rep, clock, loss)
            with self._lock:
                self._rounds += 1
            charge = self._collect(clock)
            sched, partner, remapped = t._resolve_partner(step)
            t._start_round(step, sched, partner, remapped)
            if partner != self.me and t.schedule.participates(step, self.me):
                self._launch(partner, step)
            self._charge_failures(charge, step, device)
            frames: List[tuple] = []
            merges: List[Tuple[int, float, int]] = []
            clocks: List[Tuple[int, float]] = []
            for lag, _draw, peer, _ck, raw, _span, t_land in self._drain_order(clock, step):
                if lag > int(self.cfg.max_staleness):
                    self._drop_stale(peer, raw, lag, step)
                    continue
                res = self._consume(raw, clock, loss, step, lag, device)
                del raw
                if peer == partner:
                    t.last_round["outcome"] = t.last_fetch.get("outcome")
                if res is None:
                    self._peer_stats(peer)["fails"] += 1
                    continue
                landed, damped, ck = res
                frames.append(t._classify_device_frame(landed, peer, damped))
                clocks.append((t.last_fetch["peer"], ck))
                self._note_merge(peer, lag, t_land)
                merges.append((peer, damped, lag))
            merged = t._apply_device_frames(rep.dev, frames, fold=bool(self.cfg.fold))
            if frames and self.cfg.fold:
                runs, n = [], 0
                for f in frames:
                    if f[0] == "dense":
                        n += 1
                    elif n:
                        runs.append(n)
                        n = 0
                if n:
                    runs.append(n)
                with self._lock:
                    self._fold_dispatches += sum(1 for r in runs if r >= 2)
                    self._fold_frames += sum(r for r in runs if r >= 2)
            t._count_round(clocks)
            if merged is not rep.dev:
                rep.swap(merged)
            return merged, merges
        finally:
            t._membership_end_round(step)

    def exchange(self, vec, clock: float, loss: float, step: int):
        """:meth:`exchange_on_device` for a host replica (a float32 numpy
        array or CPU tensor): ``(merged, merges)``, ``merged`` of the same
        kind, ``vec`` itself when nothing merged."""
        as_numpy = isinstance(vec, np.ndarray)
        flat = _flat(torch.from_numpy(np.ascontiguousarray(vec, dtype=np.float32))
                     if as_numpy else vec)
        merged, merges = self.exchange_on_device(flat, clock, loss, step)
        if merged is flat:
            return vec, merges
        return (merged.numpy() if as_numpy else merged), merges

    # -- plane integration ----------------------------------------------
    def pop_round_stale(self) -> List[int]:
        """Drain the peers dropped stale since the last call."""
        out, self._round_stale = self._round_stale, []
        return out

    def pending_depth(self, peer: int) -> int:
        dq = self._pending.get(peer)
        return len(dq) if dq is not None else 0

    def join_inflight(self, timeout_s: float = 5.0) -> None:
        """Wait for the in-flight fetch slots to land (teardown; never on
        the round's path)."""
        with self._lock:
            slots = [self._inflight[p] for p in sorted(self._inflight)]
        for slot in slots:
            th = slot.get("thread")
            if th is not None:
                th.join(timeout_s)

    def release(self) -> None:
        """Join the in-flight slots and give every queued frame's leases
        back to the receive ring (the transport's close)."""
        self.join_inflight()
        with self._lock:
            arrivals, self._arrivals = self._arrivals, []
        held = [raw for _peer, raw, *_ in arrivals]
        for dq in self._pending.values():
            held.extend(raw for _ck, raw, _span, _t in dq)
            dq.clear()
        for raw in held:
            self._drop(raw)

    def snapshot(self) -> dict:
        """JSON-ready async plane: the reference's ``async`` document, with
        the receive-ring bytes the queues hold now and at their peak."""
        with self._lock:
            hist = [self._hist.get(lag, 0) for lag in range(int(self.cfg.max_staleness) + 1)]
            hist.append(self._hist.get(_OVERFLOW, 0))
            out = {
                "rounds": self._rounds,
                "merges": self._merges,
                "stale_drops": self._stale_drops,
                "dup_drops": self._dup_drops,
                "shed": self._shed,
                "fold_dispatches": self._fold_dispatches,
                "fold_frames": self._fold_frames,
                "pending_wait_s": round(self._pending_wait_s, 6),
                "max_staleness": int(self.cfg.max_staleness),
                "staleness_damping": float(self.cfg.staleness_damping),
                "queue_depth": int(self.cfg.queue_depth),
                "staleness_hist": hist,
                "inflight": sorted(self._inflight),
                "held_bytes": self._held,
                "peak_held_bytes": self._peak_held,
            }
        peers = {}
        for p in sorted(self._peer):
            st = self._peer[p]
            n = st["merges"]
            peers[p] = {
                "merges": n, "stale": st["stale"], "shed": st["shed"], "fails": st["fails"],
                "pending": self.pending_depth(p), "last_lag": st["last_lag"],
                "mean_lag": round(st["lag_sum"] / n, 3) if n else None,
            }
        out["peers"] = peers
        return out


def register_metrics(registry, engine: AsyncExchangeEngine) -> None:
    """The async round plane on a ``/metrics`` registry (``dpwa_async_*``)."""
    from dpwa_tpu_torch.obs.prometheus import Family

    def collect():
        snap = engine.snapshot()
        merges = Family("dpwa_async_merges_total", "counter",
                        "Frames merged by the barrier-free async round loop")
        stale = Family("dpwa_async_stale_drops_total", "counter",
                       "Frames dropped by the bounded-staleness rule")
        lag = Family("dpwa_async_peer_last_lag", "gauge",
                     "Publish-clock lag of the last frame seen per peer")
        pend = Family("dpwa_async_pending_frames", "gauge",
                      "Frames currently queued per peer")
        hist = Family("dpwa_async_staleness_merges", "counter",
                      "Merged frames by publish-clock lag (overflow = dropped)")
        for p, info in sorted((snap.get("peers") or {}).items()):
            labels = {"peer": p}
            merges.sample(info.get("merges"), labels)
            stale.sample(info.get("stale"), labels)
            if info.get("last_lag") is not None:
                lag.sample(info.get("last_lag"), labels)
            pend.sample(info.get("pending"), labels)
        buckets = snap.get("staleness_hist") or []
        for i, n in enumerate(buckets):
            hist.sample(n, {"lag": str(i) if i < len(buckets) - 1 else "overflow"})
        return [
            merges, stale, lag, pend, hist,
            Family("dpwa_async_rounds_total", "counter",
                   "Barrier-free rounds driven").sample(snap.get("rounds")),
            Family("dpwa_async_fold_frames_total", "counter",
                   "Dense frames batched through fold dispatches").sample(
                snap.get("fold_frames")),
            Family("dpwa_async_pending_wait_seconds_total", "counter",
                   "Cumulative arrival-to-merge wait across merged frames").sample(
                snap.get("pending_wait_s")),
        ]

    registry.register(collect)
