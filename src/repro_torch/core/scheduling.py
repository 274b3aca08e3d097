"""Scheduling policy over the event-driven server core.

:class:`SyncScheduler` (``mode="sync"``) drives
:class:`repro_torch.core.server.ServerCore` through the paper's round
barrier: sample a roster, broadcast, wait for every sampled client (or the
round deadline), aggregate, repeat.  **Bit-compatible** with the
reference's loop — same roster draws, same transaction numbering
(round-scoped ``2r``/``2r+1``), same event order, same floats — pinned by
the orchestrator digests.  It emits one :class:`RoundResult` per round
into ``core.history``.  The reference's ``AsyncScheduler`` arrives in a
later slice of the port.
"""

from __future__ import annotations

import random
from typing import Optional

from repro_torch.core.server import (ARRIVED, FAILED, ClientSession,
                                    FLClient, FLConfig, RoundResult,
                                    ServerCore)


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


SCHEDULERS = {"sync": SyncScheduler}


def make_scheduler(mode: str, core: ServerCore):
    try:
        cls = SCHEDULERS[mode]
    except KeyError:
        raise ValueError(f"unknown scheduling mode {mode!r}; "
                         f"one of {sorted(SCHEDULERS)}") from None
    return cls(core)
