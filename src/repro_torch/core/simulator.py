"""Deterministic discrete-event network simulator — the NS3 stand-in.

Implements exactly what the paper uses NS3 for: a star topology of N client
nodes around one server node, point-to-point links with a data rate, a
propagation delay and a loss model, an event calendar in integer nanoseconds,
and cancellable timers (NS3 ``Simulator::Schedule``/``Cancel``).

Everything is single-threaded and seeded — a simulation replays bit-for-bit,
which the tests and benchmarks rely on.

Three engines drive the innermost loop (``Simulator(engine=...)``):

* ``"per_packet"`` (default) — the reference path: one calendar event plus
  one closure per transmitted packet, exactly the seed implementation.
* ``"batched"`` — the flight engine: a burst of packets sent over one link
  (``Node.send_burst``) is planned with vectorized numpy array ops — FIFO
  serialization starts, propagation, per-packet jitter and loss draws in
  one shot — and enters the calendar as a single *flight* instead of one
  event+closure per packet.  Runs of consecutive payload packets are then
  ingested through the receivers' bulk hooks (see :meth:`Node.register`)
  without touching the heap at all.
* ``"flow"`` — the analytic engine (``repro_torch.core.flow``): each
  transport transaction is modeled in closed form — one Binomial loss draw
  per burst, FIFO-cumsum completion times with expected jitter, recovery
  as an expected-value recursion — and schedules a handful of events
  total.  Not bit-exact against the packet engines, but statistically
  equivalent, deterministic per seed, and bit-identical to the
  reference's flow engine.

The first two engines are bit-for-bit identical: same keyed RNG draws (see
``repro_torch.core.channel``), same tie-breaking (flights carry the tie
numbers per-packet scheduling would have assigned), same stats, same final
clock.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
from bisect import bisect_left
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.channel import Link, packet_key_arrays
from repro_torch.core.packets import Packet, PacketKind

ENGINES = ("per_packet", "batched", "flow")
# The packet-level engines are bit-for-bit interchangeable; "flow" is
# statistically equivalent only, so digest-pinned runs iterate
# PACKET_ENGINES, not ENGINES.
PACKET_ENGINES = ("per_packet", "batched")

# Bursts below this size go through the scalar path even under the batched
# engine: the fixed numpy planning cost only pays for itself on real bursts.
# Either path produces identical results, so this is purely a latency knob.
_MIN_BATCH = 4

# Flat per-kind stat keys, precomputed so the hot loops do one dict lookup.
_SENT_KEY = {k: f"sent_{k.name.lower()}" for k in PacketKind}
_DELIVERED_KEY = {k: f"delivered_{k.name.lower()}" for k in PacketKind}
_DROPPED_KEY = {k: f"dropped_{k.name.lower()}" for k in PacketKind}


def _budget_error() -> RuntimeError:
    return RuntimeError("simulator event budget exceeded (livelock in a "
                        "transport state machine?)")


class _Flight:
    """One planned burst over one link: packets already sequenced by
    (arrival, tie), delivered lazily by the run loop.

    ``bytes_csum`` is the prefix sum of packet sizes in delivery order (so
    a bulk-ingested run updates byte counters in O(1)); ``safe_until`` is
    the index of the first *statically effectful* packet (non-DATA, or the
    transaction's last packet) at or after ``idx``; ``key`` is the burst's
    ``(sender addr, txn)`` when homogeneous (None otherwise), which scopes
    how far *other* flights may be ingested past this one's effectful
    packets; ``seated_tie`` is the tie of the flight's one valid calendar
    seat (stale seats are skipped on pop); ``bulk_dead`` / ``refused_idx``
    record that the receiver's bulk hook permanently / currently declined
    the flight's due packet.
    """

    __slots__ = ("packets", "arrivals", "ties", "bytes_csum", "safe_until",
                 "key", "dst", "idx", "seated_tie", "bulk_dead",
                 "refused_idx")

    def __init__(self, packets: list, arrivals: list, ties: list,
                 bytes_csum: list, safe_until: int, key, dst: "Node"):
        self.packets = packets
        self.arrivals = arrivals
        self.ties = ties
        self.bytes_csum = bytes_csum
        self.safe_until = safe_until
        self.key = key
        self.dst = dst
        self.idx = 0
        self.seated_tie = ties[0]
        self.bulk_dead = False
        self.refused_idx = -1


@dataclasses.dataclass(order=True)
class _Event:
    time_ns: int
    tie: int
    fn: Callable[[], None] = dataclasses.field(compare=False)
    cancelled: bool = dataclasses.field(compare=False, default=False)


class Timer:
    """Handle for a scheduled event; ``cancel()`` is idempotent."""

    __slots__ = ("_event",)

    def __init__(self, event: _Event):
        self._event = event

    def cancel(self) -> None:
        self._event.cancelled = True

    @property
    def active(self) -> bool:
        return not self._event.cancelled


class Node:
    """A network endpoint with an IPv4-style address.

    Transports attach themselves via ``register`` to receive packets; the
    node dispatches on (txn) so multiple concurrent transactions coexist
    (N clients talking to one server).
    """

    def __init__(self, sim: "Simulator", addr: str):
        self.sim = sim
        self.addr = addr
        self._handlers: list[Callable[[Packet], bool]] = []
        self._bulk: dict[Callable, Callable] = {}
        # (txn, peer_addr) -> handlers: O(1) dispatch for transaction-bound
        # state machines (senders), tried after the broadcast handlers — a
        # server node with hundreds of concurrent senders must not scan
        # them all for every ACK/NACK.
        self._keyed: dict[tuple[int, str], list[Callable]] = {}
        # Immutable snapshot iterated by deliver(): rebuilding it on every
        # (un)register keeps the per-packet hot path allocation-free while
        # preserving copy-on-dispatch semantics under mid-dispatch mutation.
        self._dispatch: tuple[Callable[[Packet], bool], ...] = ()
        # Bulk hook of the FIRST registered handler (receivers register
        # before senders), used by the batched engine to ingest a run of
        # consecutive DATA packets in one call. None -> per-packet dispatch.
        self._bulk0: Optional[Callable] = None

    def _rebuild(self) -> None:
        self._dispatch = tuple(self._handlers)
        self._bulk0 = (self._bulk.get(self._handlers[0])
                       if self._handlers else None)

    def register(self, handler: Callable[[Packet], bool], *,
                 bulk: Optional[Callable] = None) -> None:
        """Handler returns True if it consumed the packet.

        ``bulk``, if given, is the handler's burst-ingestion fast path:
        ``bulk(pkts, i, j, arrivals) -> consumed`` may consume a prefix of
        ``pkts[i:j]`` (consecutive packets of one flight, arrival times in
        ``arrivals``) and must behave exactly like that many per-packet
        calls.  The contract that makes deep ingestion sound:

        * only DATA packets are consumed, and their processing is a pure
          per-transaction verify-and-store — no sends, no scheduling, no
          tie consumption, no reads of global state (``sim.stats`` etc.);
        * return ``0`` to decline the due packet this time (it is
          delivered per-packet, after which the hook is consulted again);
        * return ``-1`` to decline the flight *permanently* (e.g. the
          transaction's gap machinery is armed) — the remainder of the
          flight is delivered per-packet.

        Only the first registered handler's bulk hook is ever used.
        """
        self._handlers.append(handler)
        if bulk is not None:
            self._bulk[handler] = bulk
        self._rebuild()

    def register_keyed(self, key: tuple[int, str],
                       handler: Callable[[Packet], bool]) -> None:
        """Register a handler that only wants packets whose
        ``(txn, sender addr)`` equals ``key`` — dispatched by dict lookup
        instead of the broadcast scan."""
        self._keyed.setdefault(key, []).append(handler)

    def unregister_keyed(self, key: tuple[int, str],
                         handler: Callable[[Packet], bool]) -> None:
        hs = self._keyed.get(key)
        if hs and handler in hs:
            hs.remove(handler)
            if not hs:
                del self._keyed[key]

    def deliver(self, pkt: Packet) -> None:
        for h in self._dispatch:
            if h(pkt):
                return
        hs = self._keyed.get((pkt.txn, pkt.addr))
        if hs is not None:
            for h in tuple(hs):
                if h(pkt):
                    return
        if self.sim.trace:
            self.sim.log(f"{self.addr}: unhandled packet {pkt}")

    def send(self, pkt: Packet, dest: "Node") -> None:
        self.sim.transmit(self, dest, pkt)

    def send_burst(self, pkts: Sequence[Packet], dest: "Node") -> None:
        """Send ``pkts`` back-to-back to ``dest`` (one FIFO link occupancy
        per packet, exactly like consecutive :meth:`send` calls).  Under
        the batched engine this becomes one vectorized flight; otherwise it
        falls back to per-packet sends."""
        self.sim.transmit_burst(self, dest, pkts)


class Simulator:
    """Event calendar + topology. Times are integer nanoseconds."""

    def __init__(self, *, trace: bool = False, engine: str = "per_packet"):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
        self.engine = engine
        self.now_ns: int = 0
        self._queue: list[_Event] = []
        # Batched engine: flights live in their own tuple heap (C-speed
        # comparisons) plus a registry for the deep-ingestion pass.
        self._flightq: list[tuple[int, int, _Flight]] = []
        self._active_flights: list[_Flight] = []
        self._tie_n = 0
        self._nodes: dict[str, Node] = {}
        self._links: dict[tuple[str, str], Link] = {}
        self.trace = trace
        self.trace_lines: list[str] = []
        self.events_processed: int = 0
        # Latest arrival bulk-ingested by a flight pass; folded into now_ns
        # when the calendar drains so both engines end at the same time.
        self._flight_horizon_ns: int = 0
        # Counters for benchmarks.  Per-kind counters (``sent_data``,
        # ``dropped_nack``, ``delivered_parity``, ...) appear lazily as
        # traffic of that kind occurs; the DATA triple is pre-seeded since
        # every consumer reads it.
        self.stats = {
            "packets_sent": 0, "packets_dropped": 0, "packets_delivered": 0,
            "bytes_sent": 0, "bytes_delivered": 0,
            "sent_data": 0, "dropped_data": 0, "delivered_data": 0,
        }
        # Per-hop accounting (for multi-tier topologies): directed (src, dst)
        # address pairs labeled via label_hop() accumulate sent bytes and
        # packets under their hop name.  Kept out of ``stats`` so the
        # replay digests of unlabeled simulations are untouched.
        self.hop_bytes: dict[str, int] = {}
        self.hop_packets: dict[str, int] = {}
        self._hop_of: dict[tuple[str, str], str] = {}

    # -- topology ----------------------------------------------------------
    def label_hop(self, src_addr: str, dst_addr: str, hop: str) -> None:
        """Tag the directed link ``src -> dst`` as belonging to ``hop``
        (e.g. ``"client->edge"``); all traffic sent over it accumulates in
        ``hop_bytes[hop]`` / ``hop_packets[hop]``.  Counted at send time,
        like ``stats["bytes_sent"]``, so dropped packets are included."""
        self._hop_of[(src_addr, dst_addr)] = hop
        self.hop_bytes.setdefault(hop, 0)
        self.hop_packets.setdefault(hop, 0)

    def node(self, addr: str) -> Node:
        if addr not in self._nodes:
            self._nodes[addr] = Node(self, addr)
        return self._nodes[addr]

    def connect(self, a: str, b: str, link_a_to_b: Link,
                link_b_to_a: Optional[Link] = None) -> None:
        """Install a bidirectional point-to-point link (one Link per
        direction so loss/rate can be asymmetric)."""
        self.node(a)
        self.node(b)
        self._links[(a, b)] = link_a_to_b
        self._links[(b, a)] = link_b_to_a if link_b_to_a is not None else \
            dataclasses.replace(link_a_to_b, _busy_until_ns=0)

    def star(self, server: str, clients: list[str], make_link) -> None:
        """The paper's topology: N clients around one server."""
        for c in clients:
            self.connect(c, server, make_link(), make_link())

    # -- scheduling ----------------------------------------------------------
    def schedule(self, delay_ns: int, fn: Callable[[], None]) -> Timer:
        tie = self._tie_n
        self._tie_n = tie + 1
        ev = _Event(self.now_ns + int(delay_ns), tie, fn)
        heapq.heappush(self._queue, ev)
        return Timer(ev)

    def transmit(self, src: Node, dst: Node, pkt: Packet) -> None:
        link = self._links.get((src.addr, dst.addr))
        if link is None:
            raise KeyError(f"no link {src.addr} -> {dst.addr}")
        stats = self.stats
        stats["packets_sent"] += 1
        stats["bytes_sent"] += pkt.size_bytes
        k = _SENT_KEY[pkt.kind]
        stats[k] = stats.get(k, 0) + 1
        if self._hop_of:
            hop = self._hop_of.get((src.addr, dst.addr))
            if hop is not None:
                self.hop_bytes[hop] += pkt.size_bytes
                self.hop_packets[hop] += 1
        # FIFO serialization: this packet starts when the link frees up.
        start = max(self.now_ns, link._busy_until_ns)
        ser = link.serialization_ns(pkt.size_bytes)
        link._busy_until_ns = start + ser
        arrival = start + ser + link.propagation_ns(pkt)
        if link.loss.drops(pkt):
            stats["packets_dropped"] += 1
            k = _DROPPED_KEY[pkt.kind]
            stats[k] = stats.get(k, 0) + 1
            if self.trace:
                self.log(f"t={self.now_ns}ns DROP  {src.addr}->{dst.addr} "
                         f"{pkt}")
            return
        if self.trace:
            self.log(f"t={self.now_ns}ns SEND  {src.addr}->{dst.addr} {pkt} "
                     f"arrives t={arrival}ns")

        def _deliver() -> None:
            stats["packets_delivered"] += 1
            stats["bytes_delivered"] += pkt.size_bytes
            k = _DELIVERED_KEY[pkt.kind]
            stats[k] = stats.get(k, 0) + 1
            dst.deliver(pkt)

        self.schedule(arrival - self.now_ns, _deliver)

    def transmit_burst(self, src: Node, dst: Node,
                       pkts: Sequence[Packet]) -> None:
        """Transmit a back-to-back burst over one link.

        Under ``engine="batched"`` the whole burst is planned as vectorized
        numpy ops — FIFO serialization starts, propagation + jitter, and
        loss draws in one shot — and scheduled as a single flight.  Under
        ``engine="per_packet"`` (or when tracing, so log lines stay exact)
        it falls back to per-packet :meth:`transmit` calls.  Both paths are
        bit-for-bit identical: the keyed draws are pure per-packet
        functions and the flight carries the tie numbers the per-packet
        path would have assigned.
        """
        if (self.engine != "batched" or len(pkts) < _MIN_BATCH or self.trace
                or dst._bulk0 is None):
            # No batched engine, tiny burst, exact trace lines wanted, or a
            # receiver with no bulk hook (e.g. windowed TCP, which ACKs
            # every packet — a flight would be pure overhead): per-packet.
            for p in pkts:
                self.transmit(src, dst, p)
            return
        link = self._links.get((src.addr, dst.addr))
        if link is None:
            raise KeyError(f"no link {src.addr} -> {dst.addr}")
        n = len(pkts)
        txns, kinds, seqs, attempts = packet_key_arrays(pkts)
        sizes = np.fromiter((p.size_bytes for p in pkts), np.int64, n)

        # Serialization through the scalar method, one call per *unique*
        # size (an MTU burst has at most two), so Link subclasses that
        # override serialization_ns stay exact.
        ser = np.empty(n, np.int64)
        for s in np.unique(sizes):
            ser[sizes == s] = link.serialization_ns(int(s))
        start0 = max(self.now_ns, link._busy_until_ns)
        ends = start0 + np.cumsum(ser)          # start_i + ser_i for each i
        link._busy_until_ns = int(ends[-1])
        arrivals = ends + link.propagation_array(txns, kinds, seqs, attempts)
        dropped = link.loss.drop_mask(pkts, txns, kinds, seqs, attempts)

        stats = self.stats
        stats["packets_sent"] += n
        stats["bytes_sent"] += int(sizes.sum())
        for kv, c in zip(*np.unique(kinds, return_counts=True)):
            k = _SENT_KEY[PacketKind(int(kv))]
            stats[k] = stats.get(k, 0) + int(c)
        if self._hop_of:
            hop = self._hop_of.get((src.addr, dst.addr))
            if hop is not None:
                self.hop_bytes[hop] += int(sizes.sum())
                self.hop_packets[hop] += n

        ndrop = int(dropped.sum())
        if ndrop:
            stats["packets_dropped"] += ndrop
            for kv, c in zip(*np.unique(kinds[dropped], return_counts=True)):
                k = _DROPPED_KEY[PacketKind(int(kv))]
                stats[k] = stats.get(k, 0) + int(c)
            if ndrop == n:
                return
            keep = ~dropped
            arrivals = arrivals[keep]
            sizes = sizes[keep]
            pkts = [p for p, kept in zip(pkts, keep.tolist()) if kept]

        # Survivors consume consecutive tie numbers in send order — exactly
        # what per-packet schedule() calls would have assigned.
        k = len(pkts)
        tie0 = self._tie_n
        self._tie_n = tie0 + k
        order = np.argsort(arrivals, kind="stable")
        olist = order.tolist()
        fpkts = [pkts[i] for i in olist]
        safe_until = k
        for idx, p in enumerate(fpkts):
            if p.kind != PacketKind.DATA or p.seq == p.total:
                safe_until = idx
                break
        p0 = fpkts[0]
        key = (p0.addr, p0.txn)
        if any(p.addr != p0.addr or p.txn != p0.txn for p in fpkts):
            key = None              # heterogeneous burst: bounds globally
        csum = [0]
        csum.extend(np.cumsum(sizes[order]).tolist())
        flight = _Flight(fpkts,
                         arrivals[order].tolist(),
                         [tie0 + i for i in olist],
                         csum, safe_until, key, dst)
        self._active_flights.append(flight)
        heapq.heappush(self._flightq,
                       (flight.arrivals[0], flight.ties[0], flight))

    # -- the deep-ingestion pass (batched engine) ----------------------------
    def _flight_pass(self, until_ns: Optional[int]) -> int:
        """Bulk-ingest every eligible pending flight packet below the next
        *effectful* point of the calendar; returns packets ingested.

        Bulk-eligible packet processing (see :meth:`Node.register`) is a
        pure per-transaction verify-and-store: it consumes no tie numbers,
        schedules nothing, sends nothing, and touches nothing shared across
        transactions beyond commutative counter additions.  Two such
        operations on different transactions therefore commute, so between
        two effectful points the engine may ingest flight-by-flight instead
        of in strict global arrival order and still reach a bit-identical
        state.  Effectful points — which bound the pass — are:

        * globally: the earliest pending non-flight event (timers, train
          completions, control-packet deliveries), whose handler may read
          any state and consume ties, plus the ``until_ns`` horizon of a
          paused run;
        * per transaction: the first *statically* unsafe packet (non-DATA /
          the transaction's last packet) of any flight carrying the same
          ``(sender, txn)`` key, whose processing delivers/ACKs/NACKs and
          reads the state this transaction's ingestion writes.

        Because ingestion never crosses those points, every timer handler
        still observes exactly the counters and receiver state it would
        have seen under per-packet execution, and every transaction's own
        packets are processed in exact arrival order.  Effectful packets of
        *other* transactions (their last packets, parity, declined bulk)
        do not bound a flight: their processing touches only their own
        transaction's state, and their sends/scheduling consume ties in
        true heap order, all of which commutes with this flight's ingested
        stores.  The one mid-stream approximation: such a handler sees
        ``sim.stats`` counters that already include ingested arrivals of
        other transactions (no shipped transport or FL callback reads them
        mid-run; final stats are exact either way).
        """
        act = self._active_flights
        queue = self._queue
        inf = 1 << 62
        gt, gtie = inf, inf
        if queue:
            h = queue[0]
            gt, gtie = h.time_ns, h.tie
        if until_ns is not None and until_ns < gt:
            gt, gtie = until_ns, inf
        # Per-key bounds: earliest statically unsafe packet per (addr, txn);
        # a heterogeneous (key=None) flight bounds everyone.
        key_bound: dict = {}
        compact = False
        for f in act:
            i = f.idx
            nf = len(f.packets)
            if i >= nf:
                compact = True
                continue
            su = f.safe_until
            if su >= nf:
                continue
            t2, k2 = f.arrivals[su], f.ties[su]
            if f.key is None:
                if t2 < gt or (t2 == gt and k2 < gtie):
                    gt, gtie = t2, k2
            else:
                cur = key_bound.get(f.key)
                if cur is None or t2 < cur[0] or (t2 == cur[0]
                                                  and k2 < cur[1]):
                    key_bound[f.key] = (t2, k2)

        total = 0
        stats = self.stats
        flightq = self._flightq
        horizon = self._flight_horizon_ns
        for f in act:
            i = f.idx
            nf = len(f.packets)
            if i >= nf or f.bulk_dead or f.refused_idx == i:
                continue
            bulk = f.dst._bulk0
            if bulk is None:
                continue
            bt, btie = gt, gtie
            kb = key_bound.get(f.key) if f.key is not None else None
            if kb is not None and (kb[0] < bt or (kb[0] == bt
                                                  and kb[1] < btie)):
                bt, btie = kb
            arr = f.arrivals
            ties = f.ties
            jmax = min(f.safe_until, nf)
            j = bisect_left(arr, bt, i, jmax)
            while j < jmax and arr[j] == bt and ties[j] < btie:
                j += 1
            if j <= i:
                continue
            self.now_ns = arr[i]
            c = bulk(f.packets, i, j, arr)
            if c <= 0:
                if c < 0:
                    f.bulk_dead = True
                else:
                    f.refused_idx = i
                continue
            csum = f.bytes_csum
            stats["packets_delivered"] += c
            stats["delivered_data"] += c
            stats["bytes_delivered"] += csum[i + c] - csum[i]
            total += c
            i += c
            f.idx = i
            if arr[i - 1] > horizon:
                horizon = arr[i - 1]
            if i < nf:
                if i < j:
                    # Dynamic stop before the bound: skip the wasted pass
                    # when this packet pops (the hook already declined it).
                    f.refused_idx = i
                tie2 = ties[i]
                f.seated_tie = tie2
                heapq.heappush(flightq, (arr[i], tie2, f))
            else:
                f.seated_tie = -1
                compact = True
        if compact:
            self._active_flights = [f for f in act
                                    if f.idx < len(f.packets)]
        self._flight_horizon_ns = horizon
        return total

    # -- main loop -----------------------------------------------------------
    def run(self, until_ns: Optional[int] = None, max_events: int = 10_000_000
            ) -> int:
        """Drain the calendar; returns the final simulation time."""
        n = 0
        queue = self._queue
        flightq = self._flightq
        stats = self.stats
        try:
            while queue or flightq:
                if flightq:
                    t, tie, fl = flightq[0]
                    if queue:
                        h = queue[0]
                        take_flight = (t < h.time_ns
                                       or (t == h.time_ns and tie < h.tie))
                    else:
                        take_flight = True
                else:
                    take_flight = False

                if not take_flight:
                    ev = heapq.heappop(queue)
                    if ev.cancelled:
                        continue
                    if until_ns is not None and ev.time_ns > until_ns:
                        # Put it back for a later resumed run().
                        heapq.heappush(queue, ev)
                        self.now_ns = until_ns
                        break
                    self.now_ns = ev.time_ns
                    ev.fn()
                    n += 1
                    if n >= max_events:
                        raise _budget_error()
                    continue

                entry = heapq.heappop(flightq)
                t, tie, fl = entry
                if tie != fl.seated_tie:
                    continue                    # stale seat (lazy deletion)
                if until_ns is not None and t > until_ns:
                    heapq.heappush(flightq, entry)
                    self.now_ns = until_ns
                    break
                self.now_ns = t
                i = fl.idx
                if (not fl.bulk_dead and fl.refused_idx != i
                        and i < fl.safe_until and fl.dst._bulk0 is not None):
                    n += self._flight_pass(until_ns)
                    if n >= max_events:
                        raise _budget_error()
                    if fl.idx != i:
                        # The pass ingested (and re-seated) this flight.
                        continue
                    self.now_ns = t
                # Deliver exactly one due packet through the per-packet
                # path (last packet, declined bulk, no bulk hook...).
                pkt = fl.packets[i]
                stats["packets_delivered"] += 1
                stats["bytes_delivered"] += pkt.size_bytes
                k = _DELIVERED_KEY[pkt.kind]
                stats[k] = stats.get(k, 0) + 1
                fl.dst.deliver(pkt)
                i += 1
                n += 1
                fl.idx = i
                nf = len(fl.packets)
                if fl.safe_until < i:
                    # The statically effectful packet has been processed;
                    # advance the bound to the next one so later passes are
                    # not pinned to a past arrival.
                    su, fpkts = i, fl.packets
                    while su < nf:
                        p = fpkts[su]
                        if p.kind != PacketKind.DATA or p.seq == p.total:
                            break
                        su += 1
                    fl.safe_until = su
                if n >= max_events:
                    raise _budget_error()
                if i < nf:
                    tie2 = fl.ties[i]
                    fl.seated_tie = tie2
                    heapq.heappush(flightq, (fl.arrivals[i], tie2, fl))
                else:
                    fl.seated_tie = -1
                    try:
                        self._active_flights.remove(fl)
                    except ValueError:
                        pass
            else:
                # Drained: the last processed thing may have been a
                # bulk-ingested arrival.
                if self._flight_horizon_ns > self.now_ns:
                    self.now_ns = self._flight_horizon_ns
            return self.now_ns
        finally:
            self.events_processed += n

    # -- replay digests ------------------------------------------------------
    def stats_digest(self) -> str:
        """Stable content hash of (final time, all counters) — the replay
        fingerprint the engine-equivalence tests and benchmarks compare."""
        blob = repr((self.now_ns, sorted(self.stats.items())))
        return hashlib.sha256(blob.encode()).hexdigest()

    def log(self, line: str) -> None:
        if self.trace:
            self.trace_lines.append(line)
