"""Per-client transport telemetry: the observability half of the loop.

The paper's future work asks for "optimization of the Modified UDP ... to
improve efficiency while ensuring reliability"; optimizing *per client*
first requires seeing each client.  This module is the seeing: a
:class:`Telemetry` plane owned by :class:`repro_torch.core.server.ServerCore`
that folds every transaction completion (and every explicit decode
degradation) into per-client EWMA estimators of

* ``loss_rate`` — retransmissions per data packet sent (the observable
  proxy for path loss; FEC repairs that avoided a retransmission
  correctly do not count),
* ``rtt_ns`` — whole-transaction latency (start to completion in
  simulated time),
* ``retransmissions`` — the per-transaction retransmission count,
* ``goodput_bps`` — payload bits delivered per second of transaction
  time,

plus monotonic counters (``txns``, ``failures``, ``decode_errors``).
Snapshots are immutable :class:`ClientHealth` records — what
:mod:`repro_torch.core.control` policies consume and what ``RoundResult.
client_health`` exports.

Determinism contract: the plane is **simulated-time-driven and pure** — it
consumes no RNG, schedules no events, and touches no simulator stats, so
it observes identical transactions (and produces bit-identical snapshots)
under the ``per_packet`` and ``batched`` engines.  That purity is also why it is always on:
recording cannot move any pinned digest.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: Default EWMA smoothing factor: each observation contributes a quarter,
#: so ~9 transactions cover 90% of the estimate — fast enough to track a
#: bursty edge link inside a short benchmark, smooth enough that one lucky
#: transaction does not flap a control policy.
DEFAULT_ALPHA = 0.25


@dataclasses.dataclass(frozen=True, slots=True)
class ClientHealth:
    """One client's health snapshot (immutable; safe to export/compare)."""

    addr: str
    #: Observed transactions (completed + failed).
    txns: int = 0
    #: Transactions that exhausted transport retries.
    failures: int = 0
    #: Payloads from this client explicitly degraded to zero-fill.
    decode_errors: int = 0
    #: EWMA of retransmissions / data packets per transaction.
    loss_rate: float = 0.0
    #: EWMA of whole-transaction latency (simulated ns).
    rtt_ns: float = 0.0
    #: EWMA of per-transaction retransmission count.
    retransmissions: float = 0.0
    #: EWMA of payload bits per second of transaction time.
    goodput_bps: float = 0.0
    #: Simulated time of the most recent observation.
    last_update_ns: int = 0


class _Cell:
    """Mutable per-client accumulator behind the frozen snapshots."""

    __slots__ = ("txns", "failures", "decode_errors", "loss_rate", "rtt_ns",
                 "retransmissions", "goodput_bps", "last_update_ns")

    def __init__(self) -> None:
        self.txns = 0
        self.failures = 0
        self.decode_errors = 0
        self.loss_rate = 0.0
        self.rtt_ns = 0.0
        self.retransmissions = 0.0
        self.goodput_bps = 0.0
        self.last_update_ns = 0


class Telemetry:
    """Per-client EWMA estimators fed by the server core.

    All methods are O(1) per observation and allocation-light; the plane
    sits on the transaction-completion path of every engine.
    """

    def __init__(self, alpha: float = DEFAULT_ALPHA):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"telemetry alpha must be in (0, 1], "
                             f"got {alpha}")
        self.alpha = float(alpha)
        self._cells: dict[str, _Cell] = {}

    def _cell(self, addr: str) -> _Cell:
        cell = self._cells.get(addr)
        if cell is None:
            cell = self._cells[addr] = _Cell()
        return cell

    def _ewma(self, old: float, obs: float, first: bool) -> float:
        # The first observation initializes the estimate (no cold-start
        # bias toward zero); afterwards the standard recursion.
        if first:
            return float(obs)
        return (1.0 - self.alpha) * old + self.alpha * float(obs)

    # -- feed ---------------------------------------------------------------
    def observe_txn(self, addr: str, *, now_ns: int, duration_ns: int,
                    data_sent: int, retransmissions: int,
                    payload_bytes: int, completed: bool = True) -> None:
        """Fold one finished (or failed) transaction for ``addr``."""
        cell = self._cell(addr)
        first = cell.txns == 0
        loss = retransmissions / max(1, data_sent)
        goodput = (payload_bytes * 8e9 / duration_ns
                   if completed and duration_ns > 0 else 0.0)
        cell.loss_rate = self._ewma(cell.loss_rate, loss, first)
        cell.rtt_ns = self._ewma(cell.rtt_ns, max(0, duration_ns), first)
        cell.retransmissions = self._ewma(cell.retransmissions,
                                          retransmissions, first)
        cell.goodput_bps = self._ewma(cell.goodput_bps, goodput, first)
        cell.txns += 1
        if not completed:
            cell.failures += 1
        cell.last_update_ns = int(now_ns)

    def observe_decode_error(self, addr: str, *, now_ns: int) -> None:
        """One payload from ``addr`` was explicitly degraded to zero-fill."""
        cell = self._cell(addr)
        cell.decode_errors += 1
        cell.last_update_ns = int(now_ns)

    # -- snapshots ----------------------------------------------------------
    def snapshot(self, addr: str) -> Optional[ClientHealth]:
        """The client's current :class:`ClientHealth`, or None if this
        plane has never observed it."""
        cell = self._cells.get(addr)
        if cell is None:
            return None
        return ClientHealth(
            addr=addr, txns=cell.txns, failures=cell.failures,
            decode_errors=cell.decode_errors, loss_rate=cell.loss_rate,
            rtt_ns=cell.rtt_ns, retransmissions=cell.retransmissions,
            goodput_bps=cell.goodput_bps,
            last_update_ns=cell.last_update_ns)

    def snapshot_all(self) -> dict[str, ClientHealth]:
        """Every observed client's snapshot, sorted by address (the sort
        keeps exports deterministic regardless of observation order)."""
        return {addr: self.snapshot(addr)
                for addr in sorted(self._cells)}
