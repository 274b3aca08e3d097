"""TCP-like baseline (Reno-lite) for the protocol comparison.

Models the properties the paper attributes to TCP (§IV.A): a 3-way handshake
before any data moves, per-packet cumulative acknowledgements, and
window-limited transmission (slow start + congestion avoidance + fast
retransmit + RTO). It is intentionally a simplified Reno — enough to show the
handshake/ACK overhead and loss-recovery latency that motivate MUDP, without
modelling SACK or timestamps.

The reference's flow-engine model of this transport (for
``Simulator(engine="flow")``) arrives with the flow engine in a later
slice of the port.
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
