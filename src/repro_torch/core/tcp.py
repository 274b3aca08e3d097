"""TCP-like baseline (Reno-lite) for the protocol comparison.

Models the properties the paper attributes to TCP (§IV.A): a 3-way handshake
before any data moves, per-packet cumulative acknowledgements, and
window-limited transmission (slow start + congestion avoidance + fast
retransmit + RTO). It is intentionally a simplified Reno — enough to show the
handshake/ACK overhead and loss-recovery latency that motivate MUDP, without
modelling SACK or timestamps.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.mudp import TxnStats, prep_attempt
from repro_torch.core.packets import Packet, PacketKind
from repro_torch.core.simulator import Node, Simulator, Timer


class TcpSender:
    def __init__(self, sim: Simulator, node: Node, dest: Node,
                 packets: list[Packet], *,
                 rto_ns: int = 8_000_000_000,
                 init_cwnd: float = 1.0,
                 ssthresh: float = 64.0,
                 max_rto_backoff: int = 6,
                 on_complete: Optional[Callable[["TcpSender"], None]] = None,
                 on_fail: Optional[Callable[["TcpSender"], None]] = None):
        self.sim, self.node, self.dest = sim, node, dest
        self.packets = {p.seq: p for p in packets}
        self.total = packets[0].total
        self.txn = packets[0].txn
        self.rto_ns = rto_ns
        self.cwnd = init_cwnd
        self.ssthresh = ssthresh
        self.max_rto_backoff = max_rto_backoff
        self.on_complete, self.on_fail = on_complete, on_fail
        self.stats = TxnStats(txn=self.txn, total_packets=self.total)
        self.base = 1            # lowest unacked seq
        self.next_seq = 1        # next never-sent seq
        self.dup_acks = 0
        self.backoffs = 0
        self._attempts: dict[int, int] = {s: 0 for s in self.packets}
        self._timer: Optional[Timer] = None
        self._done = False
        self._established = False
        # Keyed on (txn, responder) — see MudpSender: O(1) control-packet
        # dispatch however many concurrent senders share this node.
        node.register_keyed((self.txn, dest.addr), self._on_packet)

    # -- handshake ---------------------------------------------------------
    def start(self) -> None:
        self.stats.start_ns = self.sim.now_ns
        self.node.send(Packet(PacketKind.SYN, 0, 0, self.node.addr, self.txn),
                       self.dest)
        self._arm()

    # -- window pump ---------------------------------------------------------
    def _pump(self) -> None:
        burst = []
        while (self.next_seq <= self.total
               and self.next_seq < self.base + int(self.cwnd)):
            burst.append(self._prep(self.next_seq))
            self.next_seq += 1
        if burst:
            # The whole window goes out back-to-back: one flight under the
            # batched engine (a full cwnd once past slow start).
            self.node.send_burst(burst, self.dest)

    def _prep(self, seq: int):
        return prep_attempt(self, seq)

    def _send(self, seq: int) -> None:
        self.node.send(self._prep(seq), self.dest)

    # -- events ----------------------------------------------------------------
    def _on_packet(self, pkt: Packet) -> bool:
        # (txn, responder) match — see MudpSender._on_packet: concurrent
        # broadcast senders share a txn on one node.
        if self._done or pkt.txn != self.txn or pkt.addr != self.dest.addr:
            return False
        if pkt.kind == PacketKind.SYN_ACK and not self._established:
            self._established = True
            self.node.send(Packet(PacketKind.ACK, 1, 0, self.node.addr,
                                  self.txn), self.dest)
            self._pump()
            self._arm()
            return True
        if pkt.kind == PacketKind.ACK and self._established:
            ack = pkt.seq  # cumulative: next expected seq
            if ack > self.base:
                acked = ack - self.base
                self.base = ack
                self.dup_acks = 0
                self.backoffs = 0
                # slow start vs congestion avoidance
                for _ in range(acked):
                    if self.cwnd < self.ssthresh:
                        self.cwnd += 1.0
                    else:
                        self.cwnd += 1.0 / self.cwnd
                if self.base > self.total:
                    self.node.send(Packet(PacketKind.FIN, 0, 0,
                                          self.node.addr, self.txn), self.dest)
                    self._finish(failed=False)
                    return True
                self._pump()
                self._arm()
            elif ack == self.base:
                self.dup_acks += 1
                if self.dup_acks == 3:  # fast retransmit + Reno halving
                    self.ssthresh = max(self.cwnd / 2.0, 2.0)
                    self.cwnd = self.ssthresh
                    self.dup_acks = 0
                    self._send(self.base)
                    self._arm()
            return True
        return False

    def _on_timeout(self) -> None:
        if self._done:
            return
        if self.backoffs >= self.max_rto_backoff:
            self._finish(failed=True)
            return
        self.backoffs += 1
        self.ssthresh = max(self.cwnd / 2.0, 2.0)
        self.cwnd = 1.0
        if not self._established:
            self.node.send(Packet(PacketKind.SYN, 0, 0, self.node.addr,
                                  self.txn), self.dest)
        else:
            self._send(self.base)
        self._arm(backoff=True)

    def _arm(self, backoff: bool = False) -> None:
        if self._timer is not None:
            self._timer.cancel()
        rto = self.rto_ns * (2 ** self.backoffs if backoff else 1)
        self._timer = self.sim.schedule(rto, self._on_timeout)

    def _finish(self, *, failed: bool) -> None:
        self._done = True
        self.stats.end_ns = self.sim.now_ns
        self.stats.completed = not failed
        self.stats.failed = failed
        if self._timer is not None:
            self._timer.cancel()
        self.node.unregister_keyed((self.txn, self.dest.addr),
                                   self._on_packet)
        cb = self.on_fail if failed else self.on_complete
        if cb is not None:
            cb(self)


class TcpReceiver:
    """In-order delivery with cumulative ACKs; buffers out-of-order segments."""

    def __init__(self, sim: Simulator, node: Node, *,
                 on_deliver: Optional[
                     Callable[[str, int, dict[int, Packet]], None]] = None):
        self.sim, self.node = sim, node
        self.on_deliver = on_deliver
        self._next: dict[tuple[str, int], int] = {}
        self._buf: dict[tuple[str, int], dict[int, Packet]] = {}
        self._done: set[tuple[str, int]] = set()
        node.register(self._on_packet)

    def _on_packet(self, pkt: Packet) -> bool:
        key = (pkt.addr, pkt.txn)
        if pkt.kind == PacketKind.SYN:
            self.node.send(Packet(PacketKind.SYN_ACK, 0, 0, self.node.addr,
                                  pkt.txn), self.sim.node(pkt.addr))
            self._next.setdefault(key, 1)
            self._buf.setdefault(key, {})
            return True
        if pkt.kind == PacketKind.DATA and key in self._next:
            if key in self._done:
                self._ack(pkt.addr, pkt.txn, pkt.total + 1)
                return True
            if pkt.verify():
                self._buf[key][pkt.seq] = pkt
            nxt = self._next[key]
            while nxt in self._buf[key]:
                nxt += 1
            self._next[key] = nxt
            self._ack(pkt.addr, pkt.txn, nxt)
            if nxt > pkt.total:
                self._done.add(key)
                packets = self._buf.pop(key)
                if self.on_deliver is not None:
                    self.on_deliver(pkt.addr, pkt.txn, packets)
            return True
        if pkt.kind == PacketKind.FIN and key in self._next:
            return True
        # ACKs belong to a TcpSender (possibly on this same node) — never
        # consume them here.
        return False

    def _ack(self, addr: str, txn: int, next_expected: int) -> None:
        self.node.send(Packet(PacketKind.ACK, next_expected, 0,
                              self.node.addr, txn), self.sim.node(addr))


# --------------------------------------------------------------------------
# Flow-engine model (Simulator(engine="flow")) — see repro_torch.core.flow
# --------------------------------------------------------------------------
def _tcp_flow_model(ctx):
    """Analytic Reno-lite transaction: handshake RTT, then one Binomial per
    congestion window.  Clean windows grow cwnd exactly like the packet
    sender (slow start below ssthresh, +1/cwnd above); lossy windows repair
    gap-by-gap — the first gap via dup-ack fast retransmit when at least
    three arrivals can dup-ack, the rest via RTO waits with exponential
    backoff and the cumulative-failure cap of the packet state machine.
    Per-arrival cumulative ACK bytes are accounted so wire totals match.
    """
    from repro_torch.core.flow import CONTROL_BYTES as CB
    from repro_torch.core.flow import FlowOutcome, PH_LOSS, PH_RETX
    st = ctx.stats
    n = ctx.total
    p = ctx.p
    timeout = ctx.cfg.timeout_ns
    max_backoff = 6               # TcpSender.max_rto_backoff default
    # Handshake (control packets: lossless under the default loss models).
    ctx.count(ctx.fwd, PacketKind.SYN, 1, CB)
    _, t = ctx.fwd.occupy(ctx.sim.now_ns, [CB])
    ctx.count(ctx.rev, PacketKind.SYN_ACK, 1, CB)
    _, t = ctx.rev.occupy(t, [CB])
    ctx.count(ctx.fwd, PacketKind.ACK, 1, CB)
    ctx.fwd.occupy(t, [CB])
    base = 1
    cwnd, ssthresh = 1.0, 64.0    # TcpSender defaults
    window = 0
    t_deliver = t
    while base <= n:
        window += 1
        w = min(int(cwnd), n - base + 1)
        sizes = ctx.sizes[base - 1:base - 1 + w]
        st.data_sent += w
        _, f_last = ctx.fwd.occupy(t, sizes)
        lost = ctx.binom(w, p, PH_LOSS, window)
        ctx.count(ctx.fwd, PacketKind.DATA, w, sum(sizes),
                  lost, min(lost * ctx.chunk, sum(sizes)))
        acks = w - lost
        r_last = t
        if acks:
            # The receiver ACKs every DATA arrival (new or duplicate ack).
            ctx.count(ctx.rev, PacketKind.ACK, acks, acks * CB)
            _, r_last = ctx.rev.occupy(f_last, [CB] * acks)
        if lost == 0:
            for _ in range(w):
                cwnd = cwnd + 1.0 if cwnd < ssthresh else cwnd + 1.0 / cwnd
            base += w
            t = r_last
            t_deliver = f_last
            continue
        # Gap-by-gap recovery.  Reno without SACK recovers roughly one loss
        # per RTT (fast retransmit) or per RTO; consecutive losses of the
        # same retransmission escalate the backoff (cumulative cap -> fail).
        t = r_last
        for g in range(lost):
            if g == 0 and acks >= 3:
                wait = 0                      # three dup-acks: no timer
                ssthresh = max(cwnd / 2.0, 2.0)
                cwnd = ssthresh
            else:
                wait = timeout
                ssthresh = max(cwnd / 2.0, 2.0)
                cwnd = 1.0
            attempts = 0
            while True:
                attempts += 1
                if attempts > max_backoff:
                    return FlowOutcome(end_ns=t + wait, completed=False)
                t_fire = t + wait
                st.retransmissions += 1
                st.data_sent += 1
                _, t_arr = ctx.fwd.occupy(t_fire, [ctx.chunk])
                relost = ctx.uniform(
                    PH_RETX, window * 1024 + g * 16 + attempts) < p
                ctx.count(ctx.fwd, PacketKind.DATA, 1, ctx.chunk,
                          1 if relost else 0, ctx.chunk if relost else 0)
                if not relost:
                    ctx.count(ctx.rev, PacketKind.ACK, 1, CB)
                    _, t = ctx.rev.occupy(t_arr, [CB])
                    t_deliver = t_arr
                    break
                wait = timeout * (2 ** attempts)
        base += w
    # Final cumulative ACK arrived: FIN goes out and the sender finishes.
    ctx.count(ctx.fwd, PacketKind.FIN, 1, CB)
    ctx.fwd.occupy(t, [CB])
    return FlowOutcome(end_ns=t, completed=True, deliver_ns=t_deliver,
                       packets={p_.seq: p_ for p_ in ctx.packets},
                       total=n, complete=True)


from repro_torch.core import flow as _flow  # noqa: E402  (registration at bottom)

_flow.register_flow_model("tcp", _tcp_flow_model)
