"""Plain UDP baseline: fire-and-forget, no recovery.

The comparison the paper defers to future work ("a comparison between the
traditional UDP protocol and the Modified UDP protocol will be simulated").
The receiver delivers whatever subset arrived once it sees the last packet or
its deadline expires; missing chunks are the FL layer's problem (it zero-fills
them, which is what silently corrupts the global model and motivates MUDP).
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


# --------------------------------------------------------------------------
# Flow-engine model (Simulator(engine="flow")) — see repro_torch.core.flow
# --------------------------------------------------------------------------
def _udp_flow_model(ctx):
    """Analytic fire-and-forget transaction: one Binomial picks the loss
    count, a keyed subset picks *which* sequences vanished (the zero-filled
    gaps feed the FL layer), and the receiver delivers at the last arrival
    — or at the deadline armed by the first surviving packet when the final
    packet never shows."""
    from repro_torch.core.flow import FlowOutcome, PH_LOSS, PH_REORD, reorder_prob
    n = ctx.total
    ctx.stats.data_sent += n
    first_arr, last_arr = ctx.fwd.occupy(ctx.sim.now_ns, ctx.sizes)
    k = ctx.binom(n, ctx.p, PH_LOSS, 0)
    missing = ctx.pick_missing(k)
    dropped_bytes = sum(ctx.sizes[s - 1] for s in missing)
    ctx.count(ctx.fwd, PacketKind.DATA, n, ctx.data_bytes, k, dropped_bytes)
    now = ctx.sim.now_ns   # sender is done the moment the burst is queued
    if k >= n:
        return FlowOutcome(end_ns=now, completed=True)   # silence: no rx
    pkts = {p.seq: p for p in ctx.packets if p.seq not in missing}
    if n in missing:
        # Deadline timer armed by the first surviving arrival.  By the
        # time it fires every surviving packet is long in, so the delivery
        # holds all of them.
        s0 = min(pkts)
        ser = ctx.fwd.link.serialization_ns(ctx.chunk)
        t_del = first_arr + (s0 - 1) * ser + ctx.cfg.udp_deadline_ns
    else:
        t_del = last_arr
        # Delivery fires the instant the last packet lands, and jitter can
        # push an earlier packet *past* it: that packet misses the
        # delivery (its payload zero-fills) and its later arrival is a
        # consumed late duplicate.  Pairwise overtake probability per
        # surviving seq, exactly the spurious-NACK geometry of the mudp
        # flow model.
        jit = ctx.fwd.link.jitter_ns
        if jit > 0 and n >= 2:
            ser = ctx.fwd.link.serialization_ns(ctx.chunk)
            for i in range(1, n):
                if i in missing:
                    continue
                r = reorder_prob(jit, (n - i) * ser)
                if r > 0.0 and ctx.uniform(PH_REORD, i) < r:
                    del pkts[i]
    return FlowOutcome(end_ns=now, completed=True, deliver_ns=t_del,
                       packets=pkts, total=n, complete=len(pkts) == n)


from repro_torch.core import flow as _flow  # noqa: E402  (registration at bottom)

_flow.register_flow_model("udp", _udp_flow_model)
