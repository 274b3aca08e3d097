"""Forward-error-corrected Modified UDP (``mudp+fec``).

One concrete "Optimization of the Modified UDP" from the paper's future-work
section: the sender appends ``k`` XOR-parity packets per block of ``B`` data
packets, so the receiver repairs isolated losses *forward* — without the
NACK round-trip and retransmission MUDP would otherwise pay.  On a lossy WAN
link this trades a fixed ~1/B bandwidth overhead for fewer retransmissions
and lower tail latency.

Scheme: the ``B`` data packets of a block are split round-robin into ``k``
interleaved groups and each group gets one XOR parity packet, so up to ``k``
isolated losses per block (in distinct groups) are repairable.  Parity
packets are self-describing — the payload carries ``(data_total, B, k)`` plus
the true payload length of every covered packet — so the receiver can rebuild
a missing packet (and its checksum) exactly.

Loss patterns FEC cannot repair (two losses in one group, or a lost parity
packet) fall back to the inherited MUDP NACK machinery: the receiver defers
gap reporting for one timer period while parity is still outstanding, then
NACKs whatever is still missing.

This module is deliberately built ONLY on the public transport API
(:mod:`repro_torch.core.transport`) plus the exported MUDP state machines — it is
the worked proof that a new protocol plugs into the FL harness, benchmarks,
and examples without touching the orchestrator.
"""

from __future__ import annotations

import struct

from repro_torch.core.mudp import MudpReceiver, MudpSender, _RxState
from repro_torch.core.packets import (HEADER_BYTES, Packet, PacketKind,
                                      checksum32, make_data_packet)
from repro_torch.core.transport import (Transport, TransportCaps,
                                        adapt_full_delivery,
                                        register_transport)

_PARITY_HEAD = struct.Struct("!IHH")   # data_total, fec_block, fec_parity
_U32 = struct.Struct("!I")


# --------------------------------------------------------------------------
# Block / group geometry (pure functions; sender and receiver must agree,
# which the self-describing parity header guarantees)
# --------------------------------------------------------------------------
def parity_groups(data_total: int, block: int, k: int) -> list[list[int]]:
    """Sequence numbers covered by each parity packet, in send order."""
    groups: list[list[int]] = []
    for b0 in range(0, data_total, block):
        seqs = list(range(b0 + 1, min(b0 + block, data_total) + 1))
        kk = min(k, len(seqs))
        groups.extend(seqs[g::kk] for g in range(kk))
    return groups


def expected_parity_count(data_total: int, block: int, k: int) -> int:
    return len(parity_groups(data_total, block, k))


def make_parity_packet(parity_seq: int, n_parity: int, group: list[int],
                       data_packets: dict[int, Packet], addr: str, txn: int,
                       data_total: int, block: int, k: int) -> Packet:
    """XOR the group's payloads (zero-padded to the longest) into one packet."""
    lens = [len(data_packets[s].payload) for s in group]
    width = max(lens)
    acc = 0
    for s in group:
        acc ^= int.from_bytes(data_packets[s].payload.ljust(width, b"\x00"),
                              "big")
    payload = (_PARITY_HEAD.pack(data_total, block, k)
               + b"".join(_U32.pack(n) for n in lens)
               + acc.to_bytes(width, "big"))
    return Packet(PacketKind.PARITY, parity_seq, n_parity, addr, txn,
                  payload, checksum32(payload))


def parse_parity_packet(pkt: Packet) -> tuple[list[int], list[int], int, int]:
    """Return (covered seqs, their true lengths, xor value, xor width)."""
    data_total, block, k = _PARITY_HEAD.unpack_from(pkt.payload, 0)
    covered = parity_groups(data_total, block, k)[pkt.seq - 1]
    off = _PARITY_HEAD.size
    lens = [_U32.unpack_from(pkt.payload, off + 4 * i)[0]
            for i in range(len(covered))]
    off += 4 * len(covered)
    width = len(pkt.payload) - off
    return covered, lens, int.from_bytes(pkt.payload[off:], "big"), width


# --------------------------------------------------------------------------
# Sender: MUDP + a parity trailer after the data burst
# --------------------------------------------------------------------------
class FecMudpSender(MudpSender):
    """MUDP sender that follows the data burst with XOR parity packets.

    The NACK/timer recovery path is inherited unchanged — FEC only reduces
    how often it is exercised.
    """

    def __init__(self, sim, node, dest, packets, *,
                 fec_block: int = 8, fec_parity: int = 1, **kwargs):
        super().__init__(sim, node, dest, packets, **kwargs)
        self.fec_block = max(1, fec_block)
        # parity 0 is a valid runtime setting (the adaptive control plane
        # drops the FEC trailer entirely for clean links): the sender
        # degenerates to plain MUDP for this transaction.
        self.fec_parity = max(0, fec_parity)

    def start(self) -> None:
        super().start()   # data burst + timer; no sim time elapses in between
        if self.fec_parity == 0:
            return        # no trailer: plain MUDP recovery only
        groups = parity_groups(self.total, self.fec_block, self.fec_parity)
        trailer = [
            make_parity_packet(i + 1, len(groups), group, self.packets,
                               self.node.addr, self.txn, self.total,
                               self.fec_block, self.fec_parity)
            for i, group in enumerate(groups)
        ]
        self.stats.parity_sent += len(trailer)
        # The parity trailer queues behind the data flight on the same FIFO
        # link — a second burst, vectorized under the batched engine.
        self.node.send_burst(trailer, self.dest)


# --------------------------------------------------------------------------
# Receiver: repair from parity before falling back to NACKs
# --------------------------------------------------------------------------
class FecMudpReceiver(MudpReceiver):
    """MUDP receiver that reconstructs isolated losses from XOR parity.

    Gap reporting is deferred while parity packets are still expected (they
    trail the data burst on the FIFO link): a transaction whose every gap is
    repairable completes with ZERO NACKs.  If parity itself is lost, one
    grace timer period later the inherited NACK machinery takes over.
    """

    def __init__(self, sim, node, *, fec_block: int = 8, fec_parity: int = 1,
                 **kwargs):
        super().__init__(sim, node, **kwargs)
        self.fec_block = max(1, fec_block)
        # parity 0: never expect a trailer, never defer gap reports.
        self.fec_parity = max(0, fec_parity)
        self.stats_repairs = 0
        # key -> {parity_seq: (covered, lens, xor, width)}
        self._parity: dict[tuple[str, int],
                           dict[int, tuple[list[int], list[int], int, int]]] = {}
        # key -> n_parity as declared by the sender (any parity pkt's total);
        # until one arrives we estimate from our own config.
        self._n_parity: dict[tuple[str, int], int] = {}
        self._graced: set[tuple[str, int]] = set()

    # -- packet dispatch --------------------------------------------------
    def _ingest_run(self, pkts: list, i: int, j: int, arrivals: list) -> int:
        """Bulk ingestion is only safe while no parity has arrived for the
        transaction: once it has, every DATA arrival must run the repair
        hook in :meth:`_on_packet`, so the rest of the flight permanently
        falls back to the per-packet path."""
        p0 = pkts[i]
        if (p0.kind == PacketKind.DATA
                and self._parity.get((p0.addr, p0.txn))):
            return -1
        return super()._ingest_run(pkts, i, j, arrivals)

    def _on_packet(self, pkt: Packet) -> bool:
        if pkt.kind == PacketKind.PARITY:
            self._on_parity(pkt)
            return True
        consumed = super()._on_packet(pkt)
        if consumed and pkt.kind == PacketKind.DATA:
            key = (pkt.addr, pkt.txn)
            st = self._rx.get(key)
            if st is not None and key in self._parity:
                self._repair(key, st)
        return consumed

    def _on_parity(self, pkt: Packet) -> None:
        key = (pkt.addr, pkt.txn)
        if key in self._completed or not pkt.verify():
            return
        self._parity.setdefault(key, {})[pkt.seq] = parse_parity_packet(pkt)
        self._n_parity[key] = pkt.total
        st = self._rx.get(key)
        if st is None:
            return
        self._repair(key, st)
        st = self._rx.get(key)
        if st is None:                      # repair completed the delivery
            return
        if st.saw_last and not self._parity_outstanding(key, st):
            # Every parity packet arrived and gaps remain: FEC cannot help
            # any further, fall back to NACKs immediately.
            if not self._try_deliver(key, st):
                MudpReceiver._report_gaps(self, key, st)

    # -- forward repair ----------------------------------------------------
    def _repair(self, key: tuple[str, int], st: _RxState) -> None:
        for covered, lens, xor, width in self._parity.get(key, {}).values():
            missing = [s for s in covered if s not in st.received]
            if len(missing) != 1:
                continue
            seq = missing[0]
            acc = xor
            for s in covered:
                if s != seq:
                    acc ^= int.from_bytes(
                        st.received[s].payload.ljust(width, b"\x00"), "big")
            payload = acc.to_bytes(width, "big")[:lens[covered.index(seq)]]
            self.stats_repairs += 1
            if self.sim.trace:
                self.sim.log(f"t={self.sim.now_ns}ns {self.node.addr}: FEC "
                             f"repaired missing packet ({seq}, {st.total}, "
                             f"{st.sender_addr}) from parity")
            # Inject through the inherited machinery so delivery/ACK logic
            # stays identical to a real arrival.
            MudpReceiver._on_packet(self, make_data_packet(
                seq, st.total, st.sender_addr, payload, key[1]))
            if key not in self._rx:         # delivery completed
                return

    def _parity_outstanding(self, key: tuple[str, int], st: _RxState) -> bool:
        # Sender truth once any parity packet arrived (its `total` field);
        # before that, estimate from local config (a mismatched sender can
        # cost at most one grace period, never a livelock).
        expected = self._n_parity.get(
            key, expected_parity_count(st.total, self.fec_block,
                                       self.fec_parity))
        return len(self._parity.get(key, {})) < expected

    # -- deferred gap reporting -------------------------------------------
    def _report_gaps(self, key: tuple[str, int], st: _RxState) -> None:
        if self._parity_outstanding(key, st) and key not in self._graced:
            # Parity packets trail the data burst: give them one timer
            # period to repair the gaps before spending NACKs.
            self._graced.add(key)
            if st.nack_timer is not None:
                st.nack_timer.cancel()
            st.nack_timer = self.sim.schedule(
                self.nack_timeout_ns, lambda: self._after_grace(key))
            return
        super()._report_gaps(key, st)

    def _after_grace(self, key: tuple[str, int]) -> None:
        st = self._rx.get(key)
        if st is not None and st.saw_last and not self._try_deliver(key, st):
            MudpReceiver._report_gaps(self, key, st)

    def _try_deliver(self, key: tuple[str, int], st: _RxState) -> bool:
        done = super()._try_deliver(key, st)
        if done:
            self._parity.pop(key, None)
            self._n_parity.pop(key, None)
            self._graced.discard(key)
        return done


# --------------------------------------------------------------------------
# Registration through the public API
# --------------------------------------------------------------------------
class FecMudpTransport(Transport):
    """MUDP + per-block XOR parity (fewer retransmissions on lossy links)."""

    name = "mudp+fec"
    caps = TransportCaps(reliable=True, partial_delivery=False,
                         has_handshake=False, supports_fail_cb=True,
                         concurrent_txns=True)

    def create_sender(self, sim, src, dst, packets, cfg, *,
                      on_complete=None, on_fail=None):
        return FecMudpSender(sim, src, dst, packets,
                             fec_block=cfg.fec_block,
                             fec_parity=cfg.fec_parity,
                             timeout_ns=cfg.timeout_ns,
                             max_retries=cfg.max_retries,
                             on_complete=on_complete, on_fail=on_fail)

    def create_receiver(self, sim, node, cfg, on_deliver):
        return FecMudpReceiver(sim, node,
                               fec_block=cfg.fec_block,
                               fec_parity=cfg.fec_parity,
                               nack_timeout_ns=cfg.timeout_ns,
                               max_nack_retries=cfg.max_retries,
                               on_deliver=adapt_full_delivery(on_deliver))


register_transport("mudp+fec", FecMudpTransport)


# --------------------------------------------------------------------------
# Flow-engine model (Simulator(engine="flow")) — see repro_torch.core.flow
# --------------------------------------------------------------------------
def _fec_flow_model(ctx):
    """Analytic MUDP+FEC transaction: per-group loss draws, exact repairs.

    Per-packet losses are independent, so each parity group's loss count is
    an independent Binomial — drawn per group, which keeps the *joint*
    repair distribution exact: a group with exactly one loss is repaired
    iff its parity packet arrived; two or more losses (or a lost parity)
    fall through to the shared NACK-volley recursion.  Timing follows the
    packet receiver: repairs land at the parity trailer's arrival, a
    volley fires immediately when all parity arrived with gaps, and one
    grace timer period is paid when parity is still outstanding.
    """
    from repro_torch.core.flow import (FlowOutcome, PH_LAST, PH_LOSS, PH_REORD,
                                 reorder_prob, spurious_reorder_nacks)
    from repro_torch.core.mudp import (_mudp_flow_model, flow_ack_outcome,
                                 flow_recover, spurious_volley)
    cfg = ctx.cfg
    if cfg.fec_parity <= 0:
        # No trailer on the wire: the transaction is distributionally plain
        # MUDP (parity_groups is empty, so the packet engines send nothing
        # extra either).  Delegate so the flow engine stays equivalent.
        return _mudp_flow_model(ctx)
    n = ctx.total
    p = ctx.p
    st = ctx.stats
    st.data_sent += n
    _, last_arr = ctx.fwd.occupy(ctx.sim.now_ns, ctx.sizes)
    groups = parity_groups(n, cfg.fec_block, cfg.fec_parity)
    g = len(groups)
    # Per-group draws: data loss count, parity packet loss.
    k0 = kp = m_total = 0
    last_group = next(i for i, grp in enumerate(groups) if n in grp)
    l_last = unrep_last = 0
    for i, grp in enumerate(groups):
        li = ctx.binom(len(grp), p, PH_LOSS, 100 + i)
        pi_lost = ctx.uniform(PH_LOSS, 300 + i) < p
        k0 += li
        kp += 1 if pi_lost else 0
        unrep = li if (li >= 2 or (li == 1 and pi_lost)) else 0
        m_total += unrep
        if i == last_group:
            l_last, unrep_last = li, unrep
    last_lost = l_last > 0 and (
        ctx.uniform(PH_LAST, 0) < l_last / len(groups[last_group]))
    last_unrepaired = last_lost and unrep_last > 0 and (
        ctx.uniform(PH_LAST, 1) < unrep_last / l_last)
    dropped_bytes = ((k0 - 1) * ctx.chunk + ctx.sizes[-1] if last_lost
                     else k0 * ctx.chunk)
    ctx.count(ctx.fwd, PacketKind.DATA, n, ctx.data_bytes, k0, dropped_bytes)
    # Parity trailer: same FIFO link, queued behind the data flight.  Sizes
    # come from the group geometry alone — no packets are built.
    payload_of = {n: ctx.sizes[-1] - HEADER_BYTES}
    chunk_payload = ctx.chunk - HEADER_BYTES
    parity_sizes = [
        HEADER_BYTES + _PARITY_HEAD.size + 4 * len(grp)
        + max(payload_of.get(s, chunk_payload) for s in grp)
        for grp in groups
    ]
    st.parity_sent += g
    _, parity_arr = ctx.fwd.occupy(ctx.sim.now_ns, parity_sizes)
    ctx.count(ctx.fwd, PacketKind.PARITY, g, sum(parity_sizes),
              kp, kp * (sum(parity_sizes) // g))
    premature = False
    if not last_lost and kp == 0:
        # Jitter can land the whole parity trailer *before* the last data
        # packet.  The receiver's gap check runs ahead of its repair hook,
        # so at the last-data arrival it sees "all parity in, gaps remain"
        # and NACKs the whole gap set immediately — in-flight interiors
        # and packets parity rebuilds a moment later included.  Gate on
        # the trailer-first probability (bounded by the last parity
        # packet's send gap, the binding ordering constraint).
        trailer_gap = sum(ctx.fwd.link.serialization_ns(s)
                          for s in parity_sizes)
        gate = reorder_prob(ctx.fwd.link.jitter_ns, trailer_gap)
        premature = gate > 0.0 and ctx.uniform(PH_REORD, 0) < gate
        if premature:
            # Duplicate wire traffic: reordered in-flight survivors plus
            # the repairable losses (repair restores them right after the
            # NACKs left).  Unrepairable gaps ride the same volley, but
            # theirs is real recovery — flow_recover models it from
            # last_arr with no grace wait.
            m_s = spurious_reorder_nacks(ctx, trailer_gap_ns=trailer_gap,
                                         phase_base=64)
            m_s += k0 - m_total
            if m_total == 0:
                # Repair completes delivery at the same arrival, so the
                # ACK_OK departs right behind the NACKs and the jittered
                # reverse path decides which reaches the sender first —
                # a NACK that loses the race is never acted on.
                from repro_torch.core.flow import CONTROL_BYTES as CB
                act_p = 1.0 - reorder_prob(
                    ctx.rev.link.jitter_ns, ctx.rev.link.serialization_ns(CB))
            else:
                act_p = 1.0
            spurious_volley(ctx, m_s, last_arr, act_p=act_p)
    m = m_total - (1 if last_unrepaired else 0)
    if last_unrepaired:
        # Receiver stays silent until a keepalive duplicate of the last
        # packet arrives; flow_recover models that sender-timer phase.
        completed, t_done = flow_recover(
            ctx, m=m, last_seen=False, t_last=last_arr,
            timeout_ns=cfg.timeout_ns, max_retries=cfg.max_retries,
            retain_p=p)
    else:
        # Last packet seen: directly, or rebuilt when its parity landed.
        base = last_arr if not last_lost else parity_arr
        if premature:
            # The trailer beat the last data packet: gap check, volley and
            # repairs all happened at the last-data arrival.
            t0 = last_arr
        elif m_total == 0:
            # Delivery at the last arrival, or at the parity trailer when
            # repairs were needed to complete.
            t0 = base if k0 == 0 else max(base, parity_arr)
        elif kp == 0:
            t0 = parity_arr       # all parity in, gaps remain: NACK now
        else:
            # Grace while parity is outstanding: the receiver defers
            # silently, so no control packet ever re-arms the sender
            # keepalive — it fires first (start + timeout, before the
            # grace timer armed at the last-data arrival) and its
            # duplicate last packet is what triggers the volley,
            # spending one last-packet retry on the way.
            st.last_packet_retries += 1
            st.retransmissions += 1
            st.data_sent += 1
            dup_lost = ctx.uniform(PH_LAST, 2) < p
            last_size = ctx.sizes[-1]
            _, t_dup = ctx.fwd.occupy(ctx.sim.now_ns + cfg.timeout_ns,
                                      [last_size])
            ctx.count(ctx.fwd, PacketKind.DATA, 1, last_size,
                      1 if dup_lost else 0, last_size if dup_lost else 0)
            # If the duplicate is lost too, the receiver's grace timer
            # (armed at the last-data arrival) fires shortly after.
            t0 = t_dup if not dup_lost else base + cfg.timeout_ns
        completed, t_done = flow_recover(
            ctx, m=m, last_seen=True, t_last=t0,
            timeout_ns=cfg.timeout_ns, max_retries=cfg.max_retries,
            retain_p=p)
    if not completed:
        return FlowOutcome(end_ns=t_done, completed=False)
    return flow_ack_outcome(ctx, t_done)


from repro_torch.core import flow as _flow  # noqa: E402  (registration at bottom)

_flow.register_flow_model("mudp+fec", _fec_flow_model)
