"""The Modified UDP (MUDP) protocol — the paper's contribution (§IV.B).

Sender
  1. Sends the packets as required in quick succession.
  2. Keeps all sent packets for possible resending on packet loss.
  3. Starts a timer for determining when to resend:
     - ACK ``(0, 0, A)`` -> all packets received, transaction completes.
     - NACK ``(X, Np, A)`` with ``0 < X <= Np`` -> resend packet X.
     - Timer expiry with no acknowledgement -> resend the LAST packet to make
       the receiver report its missing sequences, with Y (=3) max retries.

Receiver
  1. Receives and stores all packets.
  2. Once the last packet (``X == Np``) is received:
     - all present -> ACK ``(0, 0, A)``, reconstruct the original payload,
       proceed with federated learning, clear storage;
     - gaps -> send a NACK per missing sequence number and start a timer for
       resending the NACKs.

The implementation is a pair of event-driven state machines over the
discrete-event simulator. They are deliberately transport-only: bytes in,
bytes out — the FL layer (``repro_torch.core.rounds``) composes them with the
packetizer and aggregation.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional

from repro_torch.core.packets import (Packet, PacketKind, make_ack_ok, make_nack)
from repro_torch.core.simulator import Node, Simulator, Timer


@dataclasses.dataclass
class TxnStats:
    """Per-transaction accounting surfaced to benchmarks/EXPERIMENTS.md."""

    txn: int
    total_packets: int = 0
    start_ns: int = 0
    end_ns: int = 0
    data_sent: int = 0
    retransmissions: int = 0
    parity_sent: int = 0          # FEC redundancy (mudp+fec), not data
    last_packet_retries: int = 0  # the paper's Y counter
    nacks_sent: int = 0
    nacks_received: int = 0
    completed: bool = False
    failed: bool = False

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


def prep_attempt(sender, seq: int) -> Packet:
    """Shared (re)transmission bookkeeping for burst/window senders
    (MUDP and TCP): bump the attempt counter, account data/retx stats,
    and return the packet stamped with its attempt number."""
    attempt = sender._attempts[seq]
    sender._attempts[seq] = attempt + 1
    sender.stats.data_sent += 1
    if attempt > 0:
        sender.stats.retransmissions += 1
    pkt = sender.packets[seq]
    if pkt.attempt != attempt:
        pkt = dataclasses.replace(pkt, attempt=attempt)
    return pkt


def ingest_data_run(pkts: list, i: int, j: int, received: dict,
                    addr: str, txn: int) -> int:
    """The bulk-contract inner loop shared by the MUDP and UDP receivers:
    verify-and-store consecutive *interior* DATA packets of transaction
    ``(addr, txn)`` from ``pkts[i:j]``; stops at any kind/addr/txn
    mismatch or the transaction's last packet.  Returns packets consumed.
    """
    adler32 = zlib.adler32
    k = i
    while k < j:
        p = pkts[k]
        if (p.kind != PacketKind.DATA or p.addr != addr or p.txn != txn
                or p.seq == p.total):
            break
        if adler32(p.payload) & 0xFFFFFFFF == p.checksum:   # == p.verify()
            received[p.seq] = p
        k += 1
    return k - i


class MudpSender:
    """One transaction: ship ``packets`` to ``dest`` reliably."""

    def __init__(self, sim: Simulator, node: Node, dest: Node,
                 packets: list[Packet], *,
                 timeout_ns: int = 6_000_000_000,
                 max_retries: int = 3,
                 on_complete: Optional[Callable[["MudpSender"], None]] = None,
                 on_fail: Optional[Callable[["MudpSender"], None]] = None):
        if not packets:
            raise ValueError("empty transaction")
        self.sim, self.node, self.dest = sim, node, dest
        self.packets = {p.seq: p for p in packets}
        self.total = packets[0].total
        self.txn = packets[0].txn
        self.timeout_ns = timeout_ns
        self.max_retries = max_retries
        self.on_complete = on_complete
        self.on_fail = on_fail
        self.stats = TxnStats(txn=self.txn, total_packets=self.total)
        self._attempts: dict[int, int] = {s: 0 for s in self.packets}
        self._timer: Optional[Timer] = None
        self._done = False
        # Keyed registration: this sender only ever consumes ACK/NACK from
        # (txn, responder), so the node dispatches by dict lookup — a
        # broadcast of N concurrent senders stays O(1) per control packet.
        node.register_keyed((self.txn, dest.addr), self._on_packet)

    # -- paper step 1: send in quick succession --------------------------
    def start(self) -> None:
        self.stats.start_ns = self.sim.now_ns
        # One burst over one link: the batched engine plans the whole
        # transaction's FIFO serialization, jitter and loss in one shot.
        # Initial transmissions are all attempt 0, so the per-seq
        # bookkeeping of _prep collapses to bulk counter updates.
        if any(a != 0 for a in self._attempts.values()) or any(
                p.attempt != 0 for p in self.packets.values()):
            burst = [self._prep(seq) for seq in range(1, self.total + 1)]
        else:
            burst = [self.packets[seq] for seq in range(1, self.total + 1)]
            self._attempts = {s: 1 for s in self._attempts}
            self.stats.data_sent += self.total
        self.node.send_burst(burst, self.dest)
        self._arm_timer()

    def _prep(self, seq: int) -> Packet:
        """Account one (re)transmission of ``seq`` and return the packet."""
        return prep_attempt(self, seq)

    def _send(self, seq: int) -> None:
        self.node.send(self._prep(seq), self.dest)

    # -- paper step 3: the timer ------------------------------------------
    def _arm_timer(self) -> None:
        self._cancel_timer()
        self._timer = self.sim.schedule(self.timeout_ns, self._on_timeout)

    def _cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _on_timeout(self) -> None:
        if self._done:
            return
        if self.stats.last_packet_retries >= self.max_retries:
            self._finish(failed=True)
            return
        # "the sender resends the last packets to inform the receiver of the
        #  missing sequences with Y amount of maximum retries"
        self.stats.last_packet_retries += 1
        if self.sim.trace:
            self.sim.log(f"t={self.sim.now_ns}ns {self.node.addr}: timer "
                         f"expired, resending last packet ({self.total}, "
                         f"{self.total}, {self.node.addr}) retry "
                         f"{self.stats.last_packet_retries}/"
                         f"{self.max_retries}")
        self._send(self.total)
        self._arm_timer()

    # -- acknowledgement handling ------------------------------------------
    def _on_packet(self, pkt: Packet) -> bool:
        # Match on (txn, responder): a server broadcast runs one sender per
        # client under the SAME txn on one node, and another client's
        # ACK/NACK must not complete or steer this transaction.
        if self._done or pkt.txn != self.txn or pkt.addr != self.dest.addr:
            return False
        if pkt.kind == PacketKind.ACK_OK:
            # "(0, 0, A) ... all packets have been received and the
            #  transaction completes."
            self._finish(failed=False)
            return True
        if pkt.kind == PacketKind.NACK:
            self.stats.nacks_received += 1
            if 0 < pkt.seq <= self.total:
                if self.sim.trace:
                    self.sim.log(f"t={self.sim.now_ns}ns {self.node.addr}: "
                                 f"NACK for missing packet {pkt.seq}, "
                                 f"resending")
                self._send(pkt.seq)
                self._arm_timer()
            return True
        return False

    def _finish(self, *, failed: bool) -> None:
        self._done = True
        self.stats.end_ns = self.sim.now_ns
        self.stats.completed = not failed
        self.stats.failed = failed
        self._cancel_timer()
        self.node.unregister_keyed((self.txn, self.dest.addr),
                                   self._on_packet)
        cb = self.on_fail if failed else self.on_complete
        if cb is not None:
            cb(self)


@dataclasses.dataclass
class _RxState:
    """Receiver-side storage for one in-flight transaction."""

    total: int
    sender_addr: str
    received: dict[int, Packet] = dataclasses.field(default_factory=dict)
    saw_last: bool = False
    nack_rounds: int = 0
    nack_timer: Optional[Timer] = None
    first_ns: int = 0


class MudpReceiver:
    """Persistent receiver serving many senders/transactions (the FL server).

    ``on_deliver(sender_addr, txn, packets)`` fires exactly once per completed
    transaction with the full ``{seq: Packet}`` map.
    """

    def __init__(self, sim: Simulator, node: Node, *,
                 nack_timeout_ns: int = 6_000_000_000,
                 max_nack_retries: int = 3,
                 on_deliver: Optional[
                     Callable[[str, int, dict[int, Packet]], None]] = None):
        self.sim, self.node = sim, node
        self.nack_timeout_ns = nack_timeout_ns
        self.max_nack_retries = max_nack_retries
        self.on_deliver = on_deliver
        self._rx: dict[tuple[str, int], _RxState] = {}
        self._completed: set[tuple[str, int]] = set()
        self.stats_nacks_sent = 0
        node.register(self._on_packet, bulk=self._ingest_run)

    def _ingest_run(self, pkts: list, i: int, j: int, arrivals: list) -> int:
        """Batched-engine fast path: ingest consecutive DATA packets of one
        flight in a single call (see ``Node.register`` for the contract).

        Consumes a prefix of ``pkts[i:j]`` that behaves exactly like that
        many :meth:`_on_packet` calls — interior (non-last) packets of one
        un-completed transaction whose last packet has not been seen, where
        the per-packet effect is precisely verify-and-store.  A completed
        transaction (per-packet re-ACKs) or armed gap machinery declines
        the flight permanently (-1); anything else unexpected declines the
        due packet (0).
        """
        p0 = pkts[i]
        if p0.kind != PacketKind.DATA:
            return 0
        key = (p0.addr, p0.txn)
        if key in self._completed:
            return -1
        st = self._rx.get(key)
        if st is None:
            st = _RxState(total=p0.total, sender_addr=p0.addr,
                          first_ns=self.sim.now_ns)
            self._rx[key] = st
        if st.saw_last:
            return -1
        return ingest_data_run(pkts, i, j, st.received, p0.addr, p0.txn)

    def _on_packet(self, pkt: Packet) -> bool:
        if pkt.kind != PacketKind.DATA:
            return False
        key = (pkt.addr, pkt.txn)
        if key in self._completed:
            # Sender missed our ACK and retried the last packet: re-ACK so it
            # can terminate (at-least-once delivery of the completion signal).
            self._send_ack(pkt.addr, pkt.txn)
            return True
        st = self._rx.get(key)
        if st is None:
            st = _RxState(total=pkt.total, sender_addr=pkt.addr,
                          first_ns=self.sim.now_ns)
            self._rx[key] = st
        if not pkt.verify():
            if self.sim.trace:
                self.sim.log(f"t={self.sim.now_ns}ns {self.node.addr}: "
                             f"checksum fail on {pkt}, treating as lost")
            return True
        st.received[pkt.seq] = pkt
        if self.sim.trace:
            self.sim.log(f"t={self.sim.now_ns}ns {self.node.addr}: got {pkt} "
                         f"[{len(st.received)}/{st.total}]")
        if pkt.is_last:
            st.saw_last = True
        if st.saw_last and not self._try_deliver(key, st) and pkt.is_last:
            # Gap reporting happens only on last-packet arrival (including a
            # timer-driven resend of it) or on the NACK timer — an interior
            # retransmission that still leaves gaps must NOT re-NACK packets
            # already in flight.
            self._report_gaps(key, st)
        return True

    # -- paper receiver step 2 ---------------------------------------------
    def _try_deliver(self, key: tuple[str, int], st: _RxState) -> bool:
        # O(1) fast path: fewer verified packets than Np means gaps for
        # sure; the O(Np) scan only runs at (potential) completion.
        if len(st.received) < st.total:
            return False
        missing = [s for s in range(1, st.total + 1) if s not in st.received]
        if missing:
            return False
        if st.nack_timer is not None:
            st.nack_timer.cancel()
        self._completed.add(key)
        packets = st.received
        del self._rx[key]
        self._send_ack(st.sender_addr, key[1])
        if self.on_deliver is not None:
            self.on_deliver(st.sender_addr, key[1], packets)
        return True

    def _report_gaps(self, key: tuple[str, int], st: _RxState) -> None:
        missing = [s for s in range(1, st.total + 1) if s not in st.received]
        # "If some packets are missing, send acknowledgements with sequence
        #  numbers of only those missing packets."  The whole NACK volley
        # goes out back-to-back, so it is one burst on the wire.
        if self.sim.trace:
            for seq in missing:
                self.sim.log(f"t={self.sim.now_ns}ns {self.node.addr}: "
                             f"packet {seq} is missing! requesting resend")
        self.stats_nacks_sent += len(missing)
        self.node.send_burst(
            [make_nack(seq, st.total, self.node.addr, key[1])
             for seq in missing],
            self.sim.node(st.sender_addr))
        # "Start the timer for determining when to resend the acknowledgement"
        if st.nack_timer is not None:
            st.nack_timer.cancel()
        if st.nack_rounds < self.max_nack_retries:
            st.nack_rounds += 1
            st.nack_timer = self.sim.schedule(
                self.nack_timeout_ns, lambda: self._on_nack_timeout(key))

    def _on_nack_timeout(self, key: tuple[str, int]) -> None:
        st = self._rx.get(key)
        if st is not None and st.saw_last and not self._try_deliver(key, st):
            self._report_gaps(key, st)

    def _send_ack(self, dest_addr: str, txn: int) -> None:
        # "(0, 0, A)" where A is the responder's address (Figs 5-7 show the
        # server responding with (0, 0, 10.1.2.5)).
        self.node.send(make_ack_ok(self.node.addr, txn),
                       self.sim.node(dest_addr))


# --------------------------------------------------------------------------
# Flow-engine model (Simulator(engine="flow")) — see repro_torch.core.flow
# --------------------------------------------------------------------------
def flow_recover(ctx, *, m: int, last_seen: bool, t_last: int,
                 timeout_ns: int, max_retries: int,
                 nack_rounds: int = 0,
                 retain_p: float | None = None) -> tuple[bool, int]:
    """The MUDP recovery machinery as an expected-value recursion, shared by
    the ``mudp`` and ``mudp+fec`` flow models.

    ``m`` interior gaps remain at the receiver; ``last_seen`` says whether
    the final packet (the paper's gap-reporting trigger) has arrived, and
    ``t_last`` is when the receiver last made progress.  Mirrors the packet
    state machines: while the last packet is unseen the receiver is silent
    and the sender keepalive timer resends it (``last_packet_retries`` is a
    cumulative budget — the timer fire after it hits ``max_retries`` fails
    the transaction); once seen, each NACK volley resends the missing set,
    with losses redrawn by seeded stochastic rounding.  Timer-armed volleys
    are budgeted by ``max_nack_retries`` (== ``max_retries``); past that,
    volleys are driven by keepalive duplicates of the last packet.

    ``retain_p`` is the probability a lost volley retransmission still
    needs another volley.  Plain MUDP leaves it ``None`` (every loss
    survives); the FEC model passes its residual-loss probability, because
    the real receiver re-runs repair on every retransmission arrival — a
    group reduced to one missing packet is rebuilt from parity on the
    spot, so only losses whose parity cover is also gone re-volley.

    Returns ``(completed, t)`` — the receiver completion time on success,
    the failing sender-timer expiry otherwise.
    """
    from repro_torch.core.flow import CONTROL_BYTES as CB
    from repro_torch.core.flow import PH_LAST, PH_RETX
    st = ctx.stats
    last_size = ctx.sizes[-1]
    fires = 0
    while not last_seen:
        # Receiver never saw the last packet: it stays silent, and the
        # sender timer (armed at start, re-armed per resend) fires at
        # start + k*timeout.
        fires += 1
        t_fire = ctx.sim.now_ns + fires * timeout_ns
        if st.last_packet_retries >= max_retries:
            return False, t_fire
        st.last_packet_retries += 1
        st.retransmissions += 1
        st.data_sent += 1
        lost = ctx.uniform(PH_LAST, fires) < ctx.p
        _, t_arr = ctx.fwd.occupy(t_fire, [last_size])
        ctx.count(ctx.fwd, PacketKind.DATA, 1, last_size,
                  1 if lost else 0, last_size if lost else 0)
        if not lost:
            last_seen = True
            t_last = t_arr
    volley = 0
    while m > 0:
        # One volley: NACK burst back, retransmission burst forward.
        volley += 1
        st.nacks_received += m
        ctx.count(ctx.rev, PacketKind.NACK, m, m * CB)
        _, t_nack = ctx.rev.occupy(t_last, [CB] * m)
        st.retransmissions += m
        st.data_sent += m
        # Loss count of the retransmission burst: the exact Binomial (an
        # integer, replayable refinement of stochastically rounding m*p —
        # same mean, and the correct P(another volley needed)).
        lost = min(m, ctx.binom(m, ctx.p, PH_RETX, volley))
        _, t_retx = ctx.fwd.occupy(t_nack, [ctx.chunk] * m)
        ctx.count(ctx.fwd, PacketKind.DATA, m, m * ctx.chunk,
                  lost, lost * ctx.chunk)
        if retain_p is not None and lost:
            # Receiver-side repair at the retransmission arrivals: only
            # losses whose parity cover is also unavailable survive.
            lost = ctx.binom(lost, retain_p, PH_RETX, 500 + volley)
        if lost == 0:
            return True, t_retx
        m = lost
        if nack_rounds < max_retries:
            # Receiver nack timer, armed when the volley went out.
            nack_rounds += 1
            t_last = t_last + timeout_ns
        else:
            # NACK-timer budget spent: the sender keepalive (re-armed by
            # the volley's NACK arrivals) resends the last packet; its
            # duplicate arrival triggers the next volley.
            waits = 0
            while True:
                waits += 1
                t_fire = t_nack + waits * timeout_ns
                if st.last_packet_retries >= max_retries:
                    return False, t_fire
                st.last_packet_retries += 1
                st.retransmissions += 1
                st.data_sent += 1
                dup_lost = ctx.uniform(
                    PH_LAST, 1000 + volley * 8 + waits) < ctx.p
                _, t_arr = ctx.fwd.occupy(t_fire, [last_size])
                ctx.count(ctx.fwd, PacketKind.DATA, 1, last_size,
                          1 if dup_lost else 0, last_size if dup_lost else 0)
                if not dup_lost:
                    t_last = t_arr
                    break
    return True, t_last


def flow_ack_outcome(ctx, t_done: int):
    """Completion tail shared by the reliable MUDP-family models: ACK_OK
    travels back and the sender finishes on its arrival."""
    from repro_torch.core.flow import CONTROL_BYTES as CB
    from repro_torch.core.flow import FlowOutcome
    ctx.count(ctx.rev, PacketKind.ACK_OK, 1, CB)
    _, t_ack = ctx.rev.occupy(t_done, [CB])
    return FlowOutcome(end_ns=t_ack, completed=True, deliver_ns=t_done,
                       packets={p.seq: p for p in ctx.packets},
                       total=ctx.total, complete=True)


def spurious_volley(ctx, m: int, t: int, act_p: float = 1.0) -> None:
    """Account a reorder-triggered NACK volley: ``m`` NACKs back and the
    acted-on subset as duplicate retransmissions forward, starting at
    ``t``.  The originals are still in flight and complete the transaction
    themselves, so the volley is pure wire overhead — no timing
    consequence beyond the link occupancy it adds (shared by the ``mudp``
    and ``mudp+fec`` models).

    ``act_p`` is the probability the sender acts on one of these NACKs:
    the completing ACK_OK races the NACKs over the same jittered reverse
    path, and a NACK that arrives after it finds the transaction already
    retired — wire bytes spent, no resend."""
    if m <= 0:
        return
    from repro_torch.core.flow import CONTROL_BYTES as CB
    from repro_torch.core.flow import PH_RETX
    st = ctx.stats
    st.nacks_received += m
    ctx.count(ctx.rev, PacketKind.NACK, m, m * CB)
    _, t_nack = ctx.rev.occupy(t, [CB] * m)
    if act_p < 1.0:
        m = ctx.binom(m, max(0.0, act_p), PH_RETX, 901)
        if m <= 0:
            return
    st.retransmissions += m
    st.data_sent += m
    lost = min(m, ctx.binom(m, ctx.p, PH_RETX, 900))
    ctx.fwd.occupy(t_nack, [ctx.chunk] * m)
    ctx.count(ctx.fwd, PacketKind.DATA, m, m * ctx.chunk,
              lost, lost * ctx.chunk)


def _mudp_flow_model(ctx):
    """Analytic MUDP transaction: one Binomial for the initial burst, the
    last-packet conditional, then the volley recursion."""
    from repro_torch.core.flow import (FlowOutcome, PH_LAST, PH_LOSS,
                                 spurious_reorder_nacks)
    cfg = ctx.cfg
    n = ctx.total
    ctx.stats.data_sent += n
    _, last_arr = ctx.fwd.occupy(ctx.sim.now_ns, ctx.sizes)
    k0 = ctx.binom(n, ctx.p, PH_LOSS, 0)
    last_lost = k0 > 0 and ctx.uniform(PH_LAST, 0) < k0 / n
    dropped_bytes = ((k0 - 1) * ctx.chunk + ctx.sizes[-1] if last_lost
                     else k0 * ctx.chunk)
    ctx.count(ctx.fwd, PacketKind.DATA, n, ctx.data_bytes, k0, dropped_bytes)
    if not last_lost:
        # Jitter reordering: in-flight interiors NACKed at last arrival.
        # The reordered original completes delivery shortly after, so its
        # ACK_OK chases the NACK down the reverse path with a head start
        # of roughly the mean residual reorder excess (~ jitter/3).
        from repro_torch.core.flow import reorder_prob
        act_p = 1.0 - reorder_prob(ctx.rev.link.jitter_ns,
                                   ctx.fwd.link.jitter_ns // 3)
        spurious_volley(ctx, spurious_reorder_nacks(ctx), last_arr,
                        act_p=act_p)
    completed, t_done = flow_recover(
        ctx, m=k0 - (1 if last_lost else 0), last_seen=not last_lost,
        t_last=last_arr, timeout_ns=cfg.timeout_ns,
        max_retries=cfg.max_retries)
    if not completed:
        return FlowOutcome(end_ns=t_done, completed=False)
    return flow_ack_outcome(ctx, t_done)


from repro_torch.core import flow as _flow  # noqa: E402  (registration at bottom)

_flow.register_flow_model("mudp", _mudp_flow_model)
