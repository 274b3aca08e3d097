"""Scheduling policies over the event-driven server core.

Two policies drive :class:`repro_torch.core.server.ServerCore`:

* :class:`SyncScheduler` (``mode="sync"``) — the paper's round barrier:
  sample a roster, broadcast, wait for every sampled client (or the round
  deadline), aggregate, repeat.  **Bit-compatible** with the reference's
  loop — same roster draws, same transaction numbering (round-scoped
  ``2r``/``2r+1``), same event order, same floats — pinned by the
  orchestrator digests.

* :class:`AsyncScheduler` (``mode="async"``) — a FedBuff-style buffered
  asynchronous server: every client runs its own session loop
  (downlink -> train -> uplink -> cadence gap -> re-enter) and the server
  aggregates whenever ``buffer_k`` updates are buffered, weighting each by
  ``staleness_discount ** staleness`` (clamped at ``staleness_floor``),
  where staleness counts server aggregations since the update's downlink.
  Sessions from different virtual rounds overlap in flight, which is why
  transaction numbering is session-scoped (``ServerCore.new_txn_pair``) and
  the transport must declare ``caps.concurrent_txns``.

Both emit one :class:`RoundResult` per aggregation into ``core.history``.
"""

from __future__ import annotations

import random
from typing import Optional

from repro_torch.core.server import (ARRIVED, DOWNLINK, FAILED, TIMEOUT,
                                     TRAINING, ClientSession, FLClient,
                                     FLConfig, RoundResult, ServerCore)


# --------------------------------------------------------------------------
# Roster sampling (sync partial participation)
# --------------------------------------------------------------------------
def sample_participants(active: list[FLClient], round_idx: int,
                        cfg: FLConfig) -> list[FLClient]:
    f = cfg.participation_fraction
    if f >= 1.0 or len(active) <= 1:
        return list(active)
    k = max(cfg.min_participants, int(round(f * len(active))))
    k = min(k, len(active))
    # Partial Fisher-Yates over indices, driven only by Random.random()
    # (the one generator method with a cross-version stability guarantee),
    # keyed by integers so PYTHONHASHSEED cannot perturb the draw.
    rng = random.Random(hash((cfg.participation_seed, round_idx)))
    idx = list(range(len(active)))
    for j in range(k):
        pick = j + int(rng.random() * (len(idx) - j))
        idx[j], idx[pick] = idx[pick], idx[j]
    return [active[i] for i in sorted(idx[:k])]


# --------------------------------------------------------------------------
# Sync: the paper's round barrier
# --------------------------------------------------------------------------
class SyncScheduler:
    """Lockstep rounds.  One shared (txn_down, txn_up) = (2r, 2r+1) pair per
    round — receivers disambiguate by sender address — so the wire traffic
    is byte-identical to the pre-refactor loop."""

    mode = "sync"

    def __init__(self, core: ServerCore):
        self.core = core
        self.cfg = core.cfg
        core.bind(self)
        self._round_idx = -1
        self._round_open = False
        self._roster: dict[str, FLClient] = {}
        self._resolved: set[str] = set()
        # addr -> update token: a flat f32 vector, or an opaque pending
        # handle (core._PendingWire) when cfg.batch_wire defers wire decode
        # to the aggregation boundary.  Schedulers never inspect the value
        # — it flows straight into core.apply_aggregation, which resolves
        # pendings in one stacked batch decode.
        self._updates: dict = {}
        self._failed: list[str] = []
        self._deadline_timer = None
        self._late_folded = 0
        self._staleness_clamped = 0
        self._retx0 = 0
        self._decode0 = core.decode_errors
        self._bcast0 = core.bcast_cache_hits
        self._round_start_ns = 0
        self._stats0 = core.snapshot_stats()

    # -- round driver ---------------------------------------------------------
    def _begin_round(self, round_idx: Optional[int],
                     txn_pair: Optional[tuple[int, int]] = None,
                     clear_sessions: bool = True) -> None:
        """Open the barrier: sample a roster, arm the deadline, start every
        session.  ``txn_pair`` overrides the round-derived ``(2r, 2r+1)``
        numbering, and ``clear_sessions=False`` keeps earlier rounds'
        sessions registered (the hierarchical cell barrier runs many
        overlapping instances over one simulator, so its rounds draw
        session-scoped pairs from ``ServerCore.new_txn_pair`` and stragglers
        must still find their sessions)."""
        core = self.core
        self._round_idx = (self._round_idx + 1 if round_idx is None
                           else round_idx)
        r = self._round_idx
        if clear_sessions:
            core.clear_sessions()
        roster = sample_participants(core.pool.active(r), r, self.cfg)
        self._roster = {c.addr: c for c in roster}
        self._resolved = set()
        self._updates = {}
        self._failed = []
        self._round_open = True
        self._late_folded = 0
        self._staleness_clamped = 0
        self._retx0 = core.retx_total
        self._decode0 = core.decode_errors
        self._bcast0 = core.bcast_cache_hits
        self._round_start_ns = core.sim.now_ns
        self._stats0 = core.snapshot_stats()

        if core.controller is not None:
            # Control step: between transactions is exactly here — last
            # round's telemetry is final, this round's sessions are not yet
            # open, so a renegotiated spec governs the whole round.
            for client in roster:
                core.apply_control(client.addr)

        if self.cfg.round_deadline_ns is not None:
            self._deadline_timer = core.sim.schedule(
                self.cfg.round_deadline_ns, self._on_deadline)

        txn_down, txn_up = txn_pair if txn_pair is not None \
            else (2 * r, 2 * r + 1)
        for client in roster:
            session = core.open_session(client, r, txn_down, txn_up,
                                        model_version=r)
            if self.cfg.broadcast_model:
                core.begin_downlink(session)
            else:
                core.begin_local(session)

    def _build_result(self) -> RoundResult:
        core = self.core
        return RoundResult(
            round_idx=self._round_idx,
            duration_ns=core.sim.now_ns - self._round_start_ns,
            arrived=sorted(self._updates.keys()),
            failed=list(self._failed),
            skipped_unhealthy=core.pool.benched(self._round_idx),
            late_folded=self._late_folded,
            retransmissions=core.retx_total - self._retx0,
            roster=sorted(self._roster),
            staleness_clamped=self._staleness_clamped,
            decode_errors=core.decode_errors - self._decode0,
            bcast_cache_hits=core.bcast_cache_hits - self._bcast0,
            client_health=core.telemetry.snapshot_all(),
            **core.stats_delta(self._stats0),
        )

    def run_round(self, round_idx: Optional[int] = None) -> RoundResult:
        self._begin_round(round_idx)
        self.core.sim.run()
        if self._round_open:       # e.g. every client failed before deadline
            self._finalize()
        return self.core.emit_result(self._build_result())

    def run_rounds(self, n: int) -> list[RoundResult]:
        return [self.run_round() for _ in range(n)]

    # -- events from the core -------------------------------------------------
    def accept_downlink(self, session: ClientSession) -> bool:
        # A downlink of the current round is honored even after the barrier
        # closed (the training it triggers uplinks into the late buffer);
        # anything older is stale traffic from a finished round.
        return session.round_idx == self._round_idx

    def on_uplink(self, session: Optional[ClientSession], addr: str,
                  txn: int, vec) -> None:
        # `vec` is an opaque update token (flat vector, or a pending wire
        # handle under cfg.batch_wire) — stored, never inspected here.
        if session is None:
            return   # txn of a cleared round: cannot occur (rounds drain)
        if session.round_idx != self._round_idx or not self._round_open:
            # Straggler from a previous round: fold next round, discounted.
            self.core.late_buffer.append((session.round_idx, addr, vec))
            return
        session.state = ARRIVED
        self._updates[addr] = vec
        self.core.pool.record_success(addr)
        self._mark_resolved(addr)

    def on_session_failed(self, session: ClientSession) -> None:
        addr = session.addr
        if addr in self._roster and addr not in self._resolved:
            session.state = FAILED
            self._failed.append(addr)
            self.core.pool.record_failure(addr, self._round_idx)
            self._mark_resolved(addr)

    def on_client_added(self, client: FLClient) -> None:
        pass   # picked up by pool.active() at the next round

    # -- barrier --------------------------------------------------------------
    def _mark_resolved(self, addr: str) -> None:
        self._resolved.add(addr)
        if self._round_open and self._resolved >= set(self._roster):
            self._finalize()

    def _on_deadline(self) -> None:
        if self._round_open:
            sim = self.core.sim
            sim.log(f"t={sim.now_ns}ns SERVER round "
                    f"{self._round_idx} deadline -> straggler cutoff "
                    f"({len(self._updates)}/{len(self._roster)} arrived)")
            self._finalize()

    def _finalize(self) -> None:
        self._round_open = False
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
            self._deadline_timer = None
        contribs = []
        for addr, vec in self._updates.items():
            contribs.append((vec, self._roster[addr].weight))
        self._late_folded, self._staleness_clamped = \
            self.core.fold_late_buffer(self._round_idx, contribs)
        self.core.apply_aggregation(contribs)


# --------------------------------------------------------------------------
# Async: FedBuff-style buffered aggregation with overlapping sessions
# --------------------------------------------------------------------------
class AsyncScheduler:
    """No barrier: clients cycle at their own cadence, the server aggregates
    every ``buffer_k`` buffered updates with staleness-discounted weights.

    ``run_rounds(n)`` performs (up to) ``n`` aggregations: it enters every
    eligible client, lets the event loop run — aggregations fire *inside*
    the loop as the buffer fills — and stops re-entering clients once the
    target is reached, letting in-flight sessions drain.  A final partial
    flush folds whatever is still buffered if the calendar drained before
    the buffer refilled (e.g. every client went unhealthy).

    ``round_deadline_ns``, when set, is promoted from round level to
    *session* level: a watchdog re-enters a client whose downlink or uplink
    is permanently stuck (a best-effort transport that lost every packet of
    a leg never raises a failure callback).  The stuck session's update is
    not lost — if it arrives later it is buffered with its staleness.
    """

    mode = "async"

    def __init__(self, core: ServerCore):
        self.core = core
        self.cfg = core.cfg
        if not core.transport.caps.concurrent_txns:
            raise ValueError(
                f"transport {core.transport.name!r} does not support "
                f"concurrent transactions per address pair "
                f"(caps.concurrent_txns=False); async scheduling needs "
                f"overlapping sessions")
        core.bind(self)
        self._agg_idx = 0
        self._model_version = 0
        self._target = 0
        self._stopped = True
        self._buffer: list[tuple[ClientSession, object, int]] = []
        self._inflight: dict[str, ClientSession] = {}
        self._idle: set[str] = set()       # parked: benched or stopped
        self._client_round: dict[str, int] = {}
        self._watchdogs: dict[int, object] = {}   # id(session) -> Timer
        # Last timed-out session per client, kept registered so a late
        # arrival is still ingested — bounded at one per client (opening
        # the next one evicts the previous from the core registries).
        self._timed_out: dict[str, ClientSession] = {}
        self._failed_window: list[str] = []
        self._timeouts_window = 0
        self._stats0 = core.snapshot_stats()
        self._retx0 = core.retx_total
        self._decode0 = core.decode_errors
        self._bcast0 = core.bcast_cache_hits
        self._window_start_ns = core.sim.now_ns

    # -- drivers --------------------------------------------------------------
    def run_round(self, round_idx: Optional[int] = None) -> RoundResult:
        if round_idx is not None:
            raise ValueError("async mode numbers aggregations itself; "
                             "explicit round_idx is sync-only")
        results = self.run_rounds(1)
        if not results:
            raise RuntimeError(
                "async run drained without a single aggregation "
                "(no client could complete an upload)")
        return results[0]

    def run_rounds(self, n: int) -> list[RoundResult]:
        core = self.core
        hist0 = len(core.history)
        self._target = self._agg_idx + n
        self._stopped = False
        self._stats0 = core.snapshot_stats()
        self._retx0 = core.retx_total
        self._decode0 = core.decode_errors
        self._bcast0 = core.bcast_cache_hits
        self._window_start_ns = core.sim.now_ns
        for client in core.pool.active(self._agg_idx):
            if client.addr not in self._inflight:
                self._enter(client)
        core.sim.run()
        if self._agg_idx < self._target and self._buffer:
            self._flush()    # drained early: fold the partial buffer
        self._stopped = True
        return core.history[hist0:]

    # -- session entry / re-entry --------------------------------------------
    def _enter(self, client: FLClient) -> None:
        core = self.core
        addr = client.addr
        self._idle.discard(addr)
        # Control step: a session entry is this client's between-transactions
        # moment — its previous transactions' telemetry is final and nothing
        # of its next session is in flight yet.
        core.apply_control(addr)
        self._client_round[addr] = self._client_round.get(addr, -1) + 1
        txn_down, txn_up = core.new_txn_pair()
        session = core.open_session(client, self._client_round[addr],
                                    txn_down, txn_up,
                                    model_version=self._model_version)
        self._inflight[addr] = session
        if self.cfg.round_deadline_ns is not None:
            self._arm_watchdog(session)
        if self.cfg.broadcast_model:
            core.begin_downlink(session)
        else:
            core.begin_local(session)

    def _schedule_reentry(self, client: FLClient) -> None:
        if client.addr not in self.core.pool.clients:
            return
        self.core.sim.schedule(max(0, client.cadence_ns),
                               lambda: self._reenter(client))

    def _reenter(self, client: FLClient) -> None:
        addr = client.addr
        if addr not in self.core.pool.clients or addr in self._inflight:
            return
        if self._stopped or self._agg_idx >= self._target:
            self._idle.add(addr)
            return
        if not self.core.pool.is_active(addr, self._agg_idx):
            self._idle.add(addr)     # benched: re-enters after readmission
            return
        self._enter(client)

    # -- watchdog (async session deadline) ------------------------------------
    def _arm_watchdog(self, session: ClientSession) -> None:
        self._watchdogs[id(session)] = self.core.sim.schedule(
            self.cfg.round_deadline_ns, lambda: self._on_watchdog(session))

    def _cancel_watchdog(self, session: ClientSession) -> None:
        timer = self._watchdogs.pop(id(session), None)
        if timer is not None:
            timer.cancel()

    def _on_watchdog(self, session: ClientSession) -> None:
        self._watchdogs.pop(id(session), None)
        if session.state in (ARRIVED, FAILED, TIMEOUT):
            return
        if session.state == TRAINING:
            # The training timer always fires; the uplink will resolve,
            # fail, or be caught by the re-armed watchdog.
            self._arm_watchdog(session)
            return
        # Stuck DOWNLINK/UPLINK: a best-effort transport lost a whole leg
        # and will never call back.  Re-enter the client; keep the session
        # registered so a miraculous late arrival is still ingested (the
        # previous timed-out session, if any, is evicted — at most one
        # lingers per client, so the registries stay bounded).
        session.state = TIMEOUT
        addr = session.addr
        if self._inflight.get(addr) is session:
            del self._inflight[addr]
        prev = self._timed_out.get(addr)
        if prev is not None:
            self.core.drop_session(prev)
        self._timed_out[addr] = session
        self._timeouts_window += 1
        # A timeout counts against health like a transport failure:
        # without this, a permanently dead best-effort client would cycle
        # timeout -> cadence -> re-enter forever, keeping the calendar
        # alive and run_rounds() from ever draining.  A merely-slow client
        # benched this way re-enters after readmit_after_rounds
        # aggregations — bench-as-backoff.
        self.core.pool.record_failure(addr, self._agg_idx)
        self._schedule_reentry(session.client)

    # -- events from the core -------------------------------------------------
    def accept_downlink(self, session: ClientSession) -> bool:
        return session.state == DOWNLINK

    def on_uplink(self, session: Optional[ClientSession], addr: str,
                  txn: int, vec) -> None:
        # `vec` is an opaque update token (flat vector, or a pending wire
        # handle under cfg.batch_wire); it is buffered untouched and only
        # decoded when _flush() hands the batch to apply_aggregation.
        if session is None or session.state in (ARRIVED, FAILED):
            return
        was_timeout = session.state == TIMEOUT
        session.state = ARRIVED
        self._cancel_watchdog(session)
        self.core.drop_session(session)
        if self._inflight.get(addr) is session:
            del self._inflight[addr]
        if self._timed_out.get(addr) is session:
            del self._timed_out[addr]
        self.core.pool.record_success(addr)
        staleness = self._model_version - session.model_version
        self._buffer.append((session, vec, staleness))
        if (len(self._buffer) >= self.cfg.buffer_k
                and not self._stopped and self._agg_idx < self._target):
            self._flush()
        if not was_timeout:
            # A timed-out session's client already re-entered at timeout.
            self._schedule_reentry(session.client)

    def on_session_failed(self, session: ClientSession) -> None:
        if session.state in (ARRIVED, FAILED, TIMEOUT):
            return
        session.state = FAILED
        self._cancel_watchdog(session)
        self.core.drop_session(session)
        addr = session.addr
        if self._inflight.get(addr) is session:
            del self._inflight[addr]
        self._failed_window.append(addr)
        self.core.pool.record_failure(addr, self._agg_idx)
        self._schedule_reentry(session.client)

    def on_client_added(self, client: FLClient) -> None:
        # Joins mid-run enter immediately (if a run is live), else at the
        # next run_rounds() entry scan.
        if not self._stopped and client.addr not in self._inflight:
            self._enter(client)

    # -- aggregation ----------------------------------------------------------
    def _flush(self) -> None:
        core = self.core
        contribs, stales, arrived = [], [], []
        clamped = dropped = 0
        for session, vec, staleness in self._buffer:
            arrived.append(session.addr)
            if (self.cfg.max_staleness is not None
                    and staleness > self.cfg.max_staleness):
                dropped += 1
                continue
            factor, was_clamped = core.staleness_factor(staleness)
            clamped += was_clamped
            contribs.append((vec, factor * session.client.weight))
            stales.append(staleness)
        if contribs:
            core.apply_aggregation(contribs)
            self._model_version += 1

        now = core.sim.now_ns
        result = RoundResult(
            round_idx=self._agg_idx,
            duration_ns=now - self._window_start_ns,
            arrived=sorted(set(arrived)),
            failed=list(self._failed_window),
            skipped_unhealthy=core.pool.benched(self._agg_idx),
            late_folded=sum(1 for s in stales if s >= 1),
            retransmissions=core.retx_total - self._retx0,
            roster=sorted(set(arrived) | set(self._inflight)),
            staleness_clamped=clamped,
            decode_errors=core.decode_errors - self._decode0,
            bcast_cache_hits=core.bcast_cache_hits - self._bcast0,
            client_health=core.telemetry.snapshot_all(),
            metrics={
                "model_version": self._model_version,
                "buffer_size": len(self._buffer),
                "staleness_mean": (sum(stales) / len(stales)
                                   if stales else 0.0),
                "staleness_max": max(stales, default=0),
                "stale_dropped": dropped,
                "session_timeouts": self._timeouts_window,
            },
            **core.stats_delta(self._stats0),
        )
        core.emit_result(result)

        self._buffer = []
        self._failed_window = []
        self._timeouts_window = 0
        self._stats0 = core.snapshot_stats()
        self._retx0 = core.retx_total
        self._decode0 = core.decode_errors
        self._bcast0 = core.bcast_cache_hits
        self._window_start_ns = now
        self._agg_idx += 1
        if self._agg_idx >= self._target:
            self._stopped = True
            return
        # Opportunity scan: parked clients (benched at their cadence tick,
        # or stopped in a previous run) whose bench expired re-enter now.
        for addr in sorted(self._idle):
            if (addr not in self._inflight
                    and self.core.pool.is_active(addr, self._agg_idx)):
                client = self.core.pool.clients.get(addr)
                if client is not None:
                    self._enter(client)


SCHEDULERS = {"sync": SyncScheduler, "async": AsyncScheduler}


def make_scheduler(mode: str, core: ServerCore):
    try:
        cls = SCHEDULERS[mode]
    except KeyError:
        raise ValueError(f"unknown scheduling mode {mode!r}; "
                         f"one of {sorted(SCHEDULERS)}") from None
    return cls(core)
