"""Plain UDP baseline: fire-and-forget, no recovery.

The comparison the paper defers to future work ("a comparison between the
traditional UDP protocol and the Modified UDP protocol will be simulated").
The receiver delivers whatever subset arrived once it sees the last packet or
its deadline expires; missing chunks are the FL layer's problem (it zero-fills
them, which is what silently corrupts the global model and motivates MUDP).

The reference's flow-engine model of this transport (for
``Simulator(engine="flow")``) arrives with the flow engine in a later
slice of the port.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.mudp import TxnStats, ingest_data_run
from repro_torch.core.packets import Packet, PacketKind
from repro_torch.core.simulator import Node, Simulator, Timer


class UdpSender:
    """Sends every packet once. Completes immediately after the burst."""

    def __init__(self, sim: Simulator, node: Node, dest: Node,
                 packets: list[Packet], *,
                 on_complete: Optional[Callable[["UdpSender"], None]] = None):
        self.sim, self.node, self.dest = sim, node, dest
        self.packets = packets
        self.stats = TxnStats(txn=packets[0].txn,
                              total_packets=packets[0].total)
        self.on_complete = on_complete

    def start(self) -> None:
        self.stats.start_ns = self.sim.now_ns
        self.stats.data_sent += len(self.packets)
        # Fire-and-forget is the ideal flight: one vectorized burst under
        # the batched engine, a plain loop of sends otherwise.
        self.node.send_burst(self.packets, self.dest)
        self.stats.end_ns = self.sim.now_ns
        self.stats.completed = True
        if self.on_complete is not None:
            self.on_complete(self)


class UdpReceiver:
    """Delivers the (possibly incomplete) packet map per transaction.

    Delivery triggers on the last packet's arrival, or on a deadline measured
    from the first packet of the transaction (covers a lost tail).
    ``on_deliver(sender_addr, txn, packets, total)``.
    """

    def __init__(self, sim: Simulator, node: Node, *,
                 deadline_ns: int = 30_000_000_000,
                 on_deliver: Optional[
                     Callable[[str, int, dict[int, Packet], int], None]] = None):
        self.sim, self.node = sim, node
        self.deadline_ns = deadline_ns
        self.on_deliver = on_deliver
        self._rx: dict[tuple[str, int], dict[int, Packet]] = {}
        self._total: dict[tuple[str, int], int] = {}
        self._timers: dict[tuple[str, int], Timer] = {}
        self._done: set[tuple[str, int]] = set()
        node.register(self._on_packet, bulk=self._ingest_run)

    def _ingest_run(self, pkts: list, i: int, j: int, arrivals: list) -> int:
        """Batched-engine fast path: one call for a run of consecutive
        non-last DATA packets — exactly the per-packet verify-and-store
        (or silent post-delivery consumption) that :meth:`_on_packet`
        performs, minus the call-per-packet overhead.

        A transaction's *first* packet is never bulk-consumed: it arms the
        deadline timer, and the bulk contract forbids scheduling (tie
        numbers must only be consumed in true event order)."""
        p0 = pkts[i]
        if p0.kind != PacketKind.DATA:
            return 0
        key = (p0.addr, p0.txn)
        addr, txn = key
        k = i
        if key in self._done:
            # Late duplicates after delivery: consumed with no effect.
            while k < j:
                p = pkts[k]
                if p.kind != PacketKind.DATA or p.addr != addr or p.txn != txn:
                    break
                k += 1
            return k - i
        rx = self._rx.get(key)
        if rx is None:
            return 0
        return ingest_data_run(pkts, k, j, rx, addr, txn)

    def _on_packet(self, pkt: Packet) -> bool:
        if pkt.kind != PacketKind.DATA:
            return False
        key = (pkt.addr, pkt.txn)
        if key in self._done:
            return True
        if key not in self._rx:
            self._rx[key] = {}
            self._total[key] = pkt.total
            self._timers[key] = self.sim.schedule(
                self.deadline_ns, lambda: self._deliver(key))
        if pkt.verify():
            self._rx[key][pkt.seq] = pkt
        if pkt.is_last:
            self._deliver(key)
        return True

    def _deliver(self, key: tuple[str, int]) -> None:
        if key in self._done or key not in self._rx:
            return
        self._done.add(key)
        self._timers[key].cancel()
        packets, total = self._rx.pop(key), self._total.pop(key)
        if self.on_deliver is not None:
            self.on_deliver(key[0], key[1], packets, total)


def reassemble_partial(packets: dict[int, Packet], total: int) -> bytes:
    """Best-effort reconstruction with zero-filled gaps (UDP baseline).

    Chunk size is inferred from any non-final packet (all equal by
    construction); a missing tail is sized the same way.
    """
    if not packets:
        return b""
    sizes = [len(p.payload) for s, p in packets.items() if s != total]
    chunk = max(sizes) if sizes else len(packets[next(iter(packets))].payload)
    out = []
    for seq in range(1, total + 1):
        if seq in packets:
            out.append(packets[seq].payload)
        elif seq < total:
            out.append(b"\x00" * chunk)
        else:  # unknown-length missing tail: assume a full chunk
            out.append(b"\x00" * chunk)
    return b"".join(out)
